// flash_attention — online-softmax attention (causal or not, GQA), written
// by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:63
// (flash_attention, body _kernel at :26, pallas_call at :85). Per query row:
// q is cast to f32 and scaled by 1/sqrt(hd) after the cast; s = q.k^T in
// f32; under `causal` the scores with q_pos < k_pos (both counted from 0)
// are -1e30, not -inf; the KV tiles are walked in order from tile 0 with an
// online softmax whose max m, denominator l and accumulator are f32, and p
// stays f32 for p.v; the output is acc / max(l, 1e-30) in q's dtype (round
// to nearest even for bf16). GQA is by index: query head h of batch row b
// reads KV head h / group, and no K or V is repeated. q, k, v and o are
// addressed through (batch, head, position) strides with the head dim
// contiguous, so the projections' transposed views need no copy.
//
// What bounds it on this card: operations. At the serving path's prefill
// (B 4, Hq 12, Hkv 2, S 2048, hd 128, causal) the two products need
// 4 * B * Hq * hd * S(S+1)/2 = 51.6 GFLOP, 52 us at the tensor cores' bf16
// rate, against 59 MB of q, k, v and o, 18 us at 3.35 TB/s. This kernel
// does not reach the tensor cores: the f32 contract keeps q.k and p in f32,
// and mma.sync or wgmma would round p (and the scaled q) to bf16 or tf32.
// It runs on the CUDA cores' f32 FMAs, whose 67 TFLOP/s put its own floor
// near 0.77 ms at that shape. That holds for the route it now serves: f32
// at every head dim, and bf16 at the small head dims (8, 16, 32). bf16 at
// head dims 64, 96 and 128, the served models' prefill, goes to the tensor
// cores in csrc/flash_attention_tc.cu, which rounds p to bf16 for p.v as the
// reference's bf16 LM path does (kernels/flash_attention/ops.py, route).
//
// What the design does about it: one block of 128 threads per (head,
// batch row, 64-row query tile); the 64-key K tile is staged in shared
// memory as f32, transposed, so that each thread's 4 x 8 score tile is an
// outer product of one float4 of q and two float4s of k per depth step
// (3 shared loads for 32 FMAs, no bank conflicts on the reads). The row max
// and row sum reduce over the 8 threads of a row by butterfly shuffles,
// which leave the same value in every lane. p goes to shared memory and V
// takes K's buffer, then each thread adds p.v into its 4 rows x hd/8
// columns of the f32 accumulator (64 registers at hd 128). Under `causal`
// a tile walks only the KV tiles up to its last row (the rest would add
// exactly 0), and the tiles that walk the most start first. Rows and keys
// past the end are loaded as 0 and masked, so any length works. Shared
// memory is 85 KiB at hd 128, two blocks per SM. With two blocks a SM and
// no overlap of a tile's loads with its products, the loads' latency is
// what a block waits on; each K or V tile load is a loop with a
// compile-time trip count, unrolled, through the read-only cache, so that
// sixteen loads a thread are in flight at once (the same loop with a
// run-time bound took twice as long at the prefill's shape).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column groups (tx)
constexpr int kPad = 4;        // keeps float4 alignment, spreads the banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

template <int HD>
struct Smem {
  static constexpr int kQS = kBQ + kPad;  // Qt[d][row]: scaled q, transposed
  static constexpr int kKS = kBK + kPad;  // Kt[d][key]: k, transposed
  static constexpr int kVS = HD + kPad;   // V[key][d], in K's buffer
  static constexpr int kPS = kBK + kPad;  // P[row][key]
  static constexpr int kQ = HD * kQS;
  static constexpr int kKV = HD * kKS > kBK * kVS ? HD * kKS : kBK * kVS;
  static constexpr int kP = kBQ * kPS;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKV + kP);
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int group, Sq, Skv, causal;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(Args a) {
  using S = Smem<HD>;
  // the output columns a thread owns: NJ chunks of VEC contiguous columns,
  // tx * VEC + j * 8 * VEC + e
  constexpr int VEC = HD >= 32 ? 4 : HD / 8;
  constexpr int NJ = HD / (8 * VEC);
  constexpr int DPT = VEC * NJ;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* KV = Qt + S::kQ;
  float* Ps = KV + S::kKV;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int hk = h / a.group;
  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;
  T* op = static_cast<T*>(a.o) + b * a.osb + h * a.osh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < a.Sq) x = to_f32(qp[(q0 + r) * a.qss + d]) * a.scale;
    Qt[d * S::kQS + r] = x;
  }
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the last tile's p.v is done with KV and Ps
#pragma unroll 16
    for (int it = 0; it < kBK * HD / kThreads; ++it) {
      const int i = it * kThreads + tid;
      const int c = i / HD, d = i % HD;
      float x = 0.f;
      if (k0 + c < a.Skv) x = to_f32(__ldg(kp + (k0 + c) * a.kss + d));
      KV[d * S::kKS + c] = x;
    }
    __syncthreads();
    // s[i][e]: row ty*4 + i, key k0 + (e / 4) * 32 + tx * 4 + e % 4
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[i][e] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qq[4], kk[8];
      load_vec<4>(&Qt[d * S::kQS + ty * 4], qq);
      load_vec<4>(&KV[d * S::kKS + tx * 4], kk);
      load_vec<4>(&KV[d * S::kKS + 32 + tx * 4], kk + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) s[i][e] = fmaf(qq[i], kk[e], s[i][e]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = k0 + (e >> 2) * 32 + tx * 4 + (e & 3);
        if (col >= a.Skv || (a.causal && r < col)) s[i][e] = kNegInf;
        mx = fmaxf(mx, s[i][e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[i][e] = expf(s[i][e] - m_new);
        sum += s[i][e];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
      float* prow = Ps + (ty * 4 + i) * S::kPS;
      *reinterpret_cast<float4*>(prow + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(prow + 32 + tx * 4) =
          make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
    }
    __syncthreads();  // every K read is done and P is written
#pragma unroll 16
    for (int it = 0; it < kBK * HD / kThreads; ++it) {
      const int i = it * kThreads + tid;
      const int c = i / HD, d = i % HD;
      float x = 0.f;
      if (k0 + c < a.Skv) x = to_f32(__ldg(vp + (k0 + c) * a.vss + d));
      KV[c * S::kVS + d] = x;
    }
    __syncthreads();
    // keys past Skv have p = 0 and v = 0, so the whole tile is summed
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float pp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_vec<4>(&Ps[(ty * 4 + i) * S::kPS + c], pp[i]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = KV + (c + cc) * S::kVS + tx * VEC;
        float vv[DPT];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          load_vec<VEC>(vrow + j * 8 * VEC, vv + j * VEC);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < DPT; ++e)
            acc[i][e] = fmaf(pp[i][cc], vv[e], acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = op + r * a.oss;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(orow + tx * VEC + j * 8 * VEC + e, acc[i][j * VEC + e] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int Hq, int B, int nq, cudaStream_t st) {
  static bool configured = false;  // the opt-in above 48 KiB, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<HD>::kBytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  flash_attention_kernel<T, HD>
      <<<dim3(Hq, B, nq), kThreads, Smem<HD>::kBytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const Args& a, int Hq, int B, int nq,
                      cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8>(a, Hq, B, nq, st);
    case 16: return launch<T, 16>(a, Hq, B, nq, st);
    case 32: return launch<T, 32>(a, Hq, B, nq, st);
    case 64: return launch<T, 64>(a, Hq, B, nq, st);
    case 96: return launch<T, 96>(a, Hq, B, nq, st);
    case 128: return launch<T, 128>(a, Hq, B, nq, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int hd, int is_bf16, int causal, int qsb,
    int qsh, int qss, int ksb, int ksh, int kss, int vsb, int vsh, int vss,
    int osb, int osh, int oss, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  const int nq = (Sq + kBQ - 1) / kBQ;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < 0 || B > 65535 || nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.group = Hq / Hkv; a.Sq = Sq; a.Skv = Skv; a.causal = causal != 0;
  a.qsb = qsb; a.qsh = qsh; a.qss = qss;
  a.ksb = ksb; a.ksh = ksh; a.kss = kss;
  a.vsb = vsb; a.vsh = vsh; a.vss = vss;
  a.osb = osb; a.osh = osh; a.oss = oss;
  // as the reference: 1/sqrt(hd) in double, rounded once to f32
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_hd<__nv_bfloat16>(hd, a, Hq, B, nq, st)
              : launch_hd<float>(hd, a, Hq, B, nq, st);
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// flash_attention_tc — online-softmax attention for bf16 on the tensor
// cores (wgmma), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:63
// (flash_attention, body _kernel at :26, pallas_call at :85) on the card's
// bf16 route: the wrapper (kernels/flash_attention/ops.py) sends bf16 at
// head dims 64, 96 and 128 here, and f32 and the small bf16 head dims to
// the split-TF32 kernel (csrc/flash_attention.cu). Per query row: s = q.k^T
// in f32 (bf16 products, f32 sums), then scaled by 1/sqrt(hd) in f32 (q is
// never rounded after scaling); under `causal` the scores with q_pos < k_pos
// (both counted from 0) are -1e30; the KV tiles are walked in order from
// tile 0 with an online softmax whose max m, denominator l and accumulator
// are f32 (taken as exp2 of the scores times log2(e), the same softmax);
// l sums the f32 p, and p is rounded to bf16 (nearest even) for the
// product p.v, as the reference's bf16 LM path rounds it
// (repro/models/layers.py chunked_attention); the output is
// acc / max(l, 1e-30), rounded to bf16. GQA is by index (query head h reads
// KV head h / group); q, k, v and o are addressed through (batch, head,
// position) strides with the head dim contiguous.
//
// What bounds it on this card: operations. At the serving path's prefill
// (B 4, Hq 12, Hkv 2, S 2048, hd 128, causal) the two products need
// 4 * B * Hq * hd * S(S+1)/2 = 51.6 GFLOP, 52 us at the tensor cores' 989
// TFLOP/s bf16 rate, against 59 MB of q, k, v and o (18 us at 3.35 TB/s).
// The f32 kernel's three TF32 products per f32 product cannot come near
// it.
//
// What the design does about it: both products run on wgmma. One block of
// two warpgroups per (query head, batch row, 128-row query tile); each
// warpgroup owns 64 query rows. Q (128 x hd) and a ring of three K/V stages
// (64 keys x hd each) live in shared memory in the layout the wgmma
// descriptors name: column blocks of 64 bf16 (hd 64, 128; 128-byte swizzle)
// or 32 bf16 (hd 96; 64-byte swizzle), each row's 16-byte chunks XOR-
// swizzled by the row. All 256 threads load with cp.async, 16 bytes each
// (the strided q/k/v views make tensor maps awkward); the load of tile
// j + 2 is issued before tile j's products, so it overlaps them, and one
// barrier a tile both publishes tile j and frees tile j - 1's stage.
// S = Q.K^T is wgmma m64n64k16 with both operands K-major in shared memory;
// the softmax runs on the f32 accumulator fragment (a row's max and sum
// over the 4 lanes that share it, by shuffles); O += P.V is wgmma
// m64n{hd}k16 with A = P converted to bf16 in registers (the accumulator
// fragment of S is the A fragment of P.V, so no shuffle) and B = V read
// MN-major from shared memory. Under `causal` a block walks the KV tiles up
// to its last row, a warpgroup skips the tiles wholly above its own rows
// (every score masked: they would add exactly 0), the mask is applied on
// the diagonal tiles only, and the heaviest query tiles start first. Rows
// and keys past the end are loaded as zeros (cp.async's zero fill) and
// masked, so any length works with no padding copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBQ = 128;       // query rows a block: two warpgroups of 64
constexpr int kBK = 64;        // keys a K/V tile
constexpr int kThreads = 256;
constexpr int kStages = 3;     // the K/V ring
constexpr float kNegInf = -1e30f;

// the shared-memory layout at head dim HD: each operand is HD / CB column
// blocks of CB bf16 (SW bytes a row), every block 1024-byte aligned
template <int HD>
struct Layout {
  static constexpr int SW = HD % 64 == 0 ? 128 : 64;   // swizzle bytes
  static constexpr int CB = SW / 2;
  static constexpr uint32_t kQ = kBQ * HD * 2;
  static constexpr uint32_t kKV = kBK * HD * 2;
  static constexpr int kBytes = kQ + 2 * kStages * kKV + 1024;  // + align
  static constexpr uint64_t kMode = SW == 128 ? 1 : 2;  // descriptor layout
  static_assert(HD % CB == 0, "head dim not a whole number of blocks");
};

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int group, Sq, Skv, causal;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
};

// byte offset of row r's 16-byte chunk c in a column block of SW-byte rows:
// the chunk index XORed with the row's bits, as the wgmma swizzle reads it
template <int SW>
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  const uint32_t off = static_cast<uint32_t>(r * SW + c * 16);
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// ROWS x HD bf16 from global rows (row0 + r) * stride, into the column
// blocks at dst; rows at or past `valid` are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int row0,
                                          int valid) {
  using L = Layout<HD>;
  constexpr int kChunks = HD / 8;                  // 16-byte chunks a row
  constexpr int kPerBlock = L::CB / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "uneven tile load");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < valid;
    const __nv_bfloat16* s =
        ok ? src + static_cast<int64_t>(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + (c / kPerBlock) * (ROWS * L::SW) +
                   swizzle<L::SW>(r, c % kPerBlock),
               s, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode
template <int HD>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (Layout<HD>::kMode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulator
// registers across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d (64 x 96, f32) += A (64 x 16, bf16 registers) . B (16 x 96, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


// O (64 x HD) += P (64 x 16) . V (16 x HD)
template <int HD>
__device__ __forceinline__ void pv_mma(float (&o)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 96) wgmma_rs_n96(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const Args a) {
  using L = Layout<HD>;
  constexpr int NO = HD / 2;                       // O fragment registers
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t sK = sQ + L::kQ;                  // stage s: + s * kKV
  const uint32_t sV = sK + kStages * L::kKV;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  const int hk = h / a.group;
  const __nv_bfloat16* qp = a.q + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kp = a.k + b * a.ksb + hk * a.ksh;
  const __nv_bfloat16* vp = a.v + b * a.vsb + hk * a.vsh;
  __nv_bfloat16* op = a.o + b * a.osb + h * a.osh;

  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int nt = (kv_end + kBK - 1) / kBK;
  // K/V tile j goes to stage j % kStages; tiles 0 and 1 start now
  auto load_kv = [&](int j) {
    const uint32_t off = (j % kStages) * L::kKV;
    load_tile<HD, kBK>(sK + off, kp, a.kss, j * kBK, a.Skv);
    load_tile<HD, kBK>(sV + off, vp, a.vss, j * kBK, a.Skv);
    cp_async_commit();
  };
  load_tile<HD, kBQ>(sQ, qp, a.qss, q0, a.Sq);
  if (nt > 0) load_kv(0);
  else cp_async_commit();
  if (nt > 1) load_kv(1);

  // this thread's two rows of its warpgroup's 64
  const int w0 = q0 + wg * 64;                     // the warpgroup's first row
  const int r0 = w0 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = (lane & 3) * 2;                   // first column of a pair
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in log2 units
  const float scale2 = a.scale * 1.4426950408889634f;   // and log2(e)
  constexpr uint32_t kSbo = 8 * L::SW;             // 8 rows of a block
  constexpr uint32_t kVLbo = kBK * L::SW;          // V's next column block

  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) cp_async_wait<1>();            // tile j has landed
    else cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // every thread's part of tile j is visible, and every warpgroup is
    // done with tile j - 1, whose stage tile j + 2 now takes
    __syncthreads();
    if (j + 2 < nt) load_kv(j + 2);
    const int k0 = j * kBK;
    if (!(a.causal && k0 > w0 + 63)) {             // uniform in the group
      const uint32_t off = (j % kStages) * L::kKV;
      const uint32_t tk = sK + off, tv = sV + off;
      // S = Q . K^T, f32
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int cb = kk * 16 / L::CB;
        const uint32_t in = (kk * 16 % L::CB) * 2;
        const uint64_t da = desc<HD>(
            sQ + cb * (kBQ * L::SW) + wg * 64 * L::SW + in, 16, kSbo);
        const uint64_t db = desc<HD>(tk + cb * (kBK * L::SW) + in, 16, kSbo);
        wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      // scale in f32 (with log2(e), for exp2), mask on the diagonal and
      // ragged tiles only
      const bool edge =
          k0 + kBK > a.Skv || (a.causal && k0 + kBK - 1 > w0);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale2;
        if (edge) {
          const int col = k0 + (i >> 2) * 8 + cq + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (col >= a.Skv || (a.causal && row < col)) x = kNegInf;
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] - ((i & 2) ? n1 : n0));
        s[i] = p;
        if (i & 2) sum1 += p;
        else sum0 += p;
      }
      l0 = l0 * c0 + sum0;                         // this lane's columns
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? c1 : c0;
      // P in bf16: the S fragment of keys 16kk.. is the A fragment
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      // O += P . V
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        pv_mma<HD>(o, pa[kk],
                   desc<HD>(tv + kk * 16 * L::SW, kVLbo, kSbo));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
    }
  }
  cp_async_wait<0>();
  // the row sums over the 4 lanes of a row, then the output
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j8 = 0; j8 < HD / 8; ++j8) {
    const int col = j8 * 8 + cq;
    if (r0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + r0 * a.oss + col) =
          __floats2bfloat162_rn(o[4 * j8] / d0, o[4 * j8 + 1] / d0);
    if (r1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + r1 * a.oss + col) =
          __floats2bfloat162_rn(o[4 * j8 + 2] / d1, o[4 * j8 + 3] / d1);
  }
}

template <int HD>
cudaError_t launch(const Args& a, int Hq, int B, int nq, cudaStream_t st) {
  static bool configured = false;                  // the opt-in above 48 KiB
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::kBytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  flash_attention_tc_kernel<HD>
      <<<dim3(Hq, B, nq), kThreads, Layout<HD>::kBytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int hd, int causal, int qsb, int qsh, int qss,
    int ksb, int ksh, int kss, int vsb, int vsh, int vss, int osb, int osh,
    int oss, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  const int nq = (Sq + kBQ - 1) / kBQ;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv < 0 || B > 65535 || nq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // cp.async moves 16 bytes: every row must start 16-byte aligned
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  for (int s : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss})
    if (s % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.group = Hq / Hkv; a.Sq = Sq; a.Skv = Skv; a.causal = causal != 0;
  a.qsb = qsb; a.qsh = qsh; a.qss = qss;
  a.ksb = ksb; a.ksh = ksh; a.kss = kss;
  a.vsb = vsb; a.vsh = vsh; a.vss = vss;
  a.osb = osb; a.osh = osh; a.oss = oss;
  // as the f32 kernel: 1/sqrt(hd) in double, rounded once to f32
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 64: e = launch<64>(a, Hq, B, nq, st); break;
    case 96: e = launch<96>(a, Hq, B, nq, st); break;
    case 128: e = launch<128>(a, Hq, B, nq, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_tc_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

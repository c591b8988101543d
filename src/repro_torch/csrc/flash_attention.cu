// flash_attention — online-softmax attention (causal or not, GQA) with the
// f32 contract, on the tensor cores by split TF32, written by hand for
// Hopper (sm_90a).
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
// contiguous, so the projections' transposed views need no copy. The route
// (kernels/flash_attention/ops.py) sends f32 at every head dim here, and
// bf16 at head dims 8, 16 and 32 (converted to f32 on load); bf16 at 64, 96
// and 128 goes to csrc/flash_attention_tc.cu.
//
// What bounds it on this card: operations. At the serving path's prefill
// shape (B 4, Hq 12, Hkv 2, S 2048, hd 128, causal) the two products need
// 4 * B * Hq * hd * S(S+1)/2 = 51.6 GFLOP. One TF32 tensor-core product
// keeps 10 bits of each operand, short of the 2e-5 contract, so each f32
// product here is three TF32 products (split TF32): x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and
// a.b = lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms first; only
// lo_a.lo_b (2^-22 of a.b) is dropped. The tensor cores round their f32
// sums toward zero, so the products of 4 k-steps of q.k^T (of a tile, for
// p.v) are chained from zero and then added to the running f32 sums by the
// CUDA cores, rounded to nearest (chained through the tensor cores over a
// whole row, the one-sided roundings gave 10x the f32 kernel's error:
// 7.7e-5 on the prefill's layer 27, past 2e-5). Three passes at the card's
// 495 TFLOP/s dense TF32 rate take 0.3125 ms; the f32 bytes of q, k, v and
// o (117 MB) 0.035 ms; the CUDA cores' f32 FMAs (67 TFLOP/s) could not go
// below 0.77 ms.
//
// What the design does about it: one block of 8 warps (two warpgroups)
// per (query head, batch row, 128-row query tile). The block's q rows stay
// in shared memory as scaled f32 for the whole walk, split into hi/lo as
// each k-step reads them (held in registers they spilled). K and V come in
// tiles of 32 keys, copied as f32 by cp.async, 16 bytes a copy, tile j + 1
// in flight while tile j is used; the block then splits the tile into
// hi/lo once, in the layout the products read (split by each warp as it
// read its fragments, the splits were most of the kernel's instructions).
// From head dim 64 both products are wgmma with A (q, then p) in
// registers and B from shared memory, K and V^T hi/lo in 128-byte
// swizzled K-major rows: a warpgroup's 64 rows at once, issued without
// waiting, the tensor cores' f32 chains of 4 k-steps in two accumulators
// in turn, so that one runs while the other's sum is added. Below head dim
// 64, mma.sync.m16n8k8 (a warp's 16 rows), each thread loading its K and
// V fragments' hi and lo as one 16-byte load from padded rows free of bank
// conflicts; a k-step's 8 depths are permuted so that a thread's two
// (logical t and t + 4) are adjacent. p never leaves registers: the
// accumulator fragment of S (columns 2t and 2t + 1 of each 8-key block)
// becomes the A fragment of p.v as is, by storing V's keys in the same
// order (V^T needs a transposed copy for wgmma, whose TF32 form reads only
// K-major operands; mma.sync reads V in place). The row max and sum reduce
// over the 4 lanes that share a row by shuffles. Under `causal` a block
// walks the KV tiles up to its last row, the rows of a product (a warp's,
// or a warpgroup's) skip the tiles wholly above them (every score masked:
// they would add exactly 0), the mask is computed on edge tiles only, and
// the heaviest query tiles start first. Rows and keys past the end are
// loaded as zeros (cp.async's zero fill) and masked, so any length works.
// Shared memory is ~200 KiB at hd 128: one block a SM. bf16 inputs, and
// f32 rows not 16-byte aligned, take the same kernel with the tile copies
// made by the threads (load, convert, store) instead of cp.async. What
// holds it back: the block-wide split pass and its two barriers every 32
// keys, which also keep the two warpgroups in step, so that one's softmax
// does not overlap the other's products (tools/flash_attention_variants.py
// times each piece).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kBQ = 16 * kWarps;  // query rows a block, 16 a warp
constexpr int kBK = 32;           // keys a K/V tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;        // f32 K/V tiles in flight (cp.async)
// q.k^T's k-steps whose products are chained in the tensor cores before
// their sum is added to the f32 scores, rounded to nearest (p.v chains a
// whole tile's): the tensor cores round toward zero, and chained over a
// whole row those roundings add up with one sign (measured: 10x the f32
// kernel's error)
constexpr int kChain = 4;
// head dims from which both products are wgmma (a warpgroup's 64 rows at
// once, B read from shared memory); below, mma.sync (a warp's 16 rows)
constexpr int kWgmmaFrom = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Shared memory, in floats: Q f32 [row][kKS]; the f32 K and V tiles as
// cp.async lands them, K [key][kKS], V [key][kVS]; and the tile split into
// TF32 hi/lo for the products. mma.sync: K as [key][depth pair] float4
// {hi 2p, hi 2p+1, lo 2p, lo 2p+1} (kKS2 floats a key), V as [key pair]
// [column] float4 {hi of keys 2p, 2p+1, lo of keys 2p, 2p+1} (kVS2 floats
// a key pair); row strides keep every fragment load free of bank
// conflicts: Q's by 16 lanes (8 mod 32 words), the hi/lo 16-byte loads by
// 8 lanes (K 16 mod 32, V 8 mod 32). wgmma: see split_tile_wg.
template <int HD>
struct Smem {
  static constexpr bool kWg = HD >= kWgmmaFrom;
  static constexpr int kKS = HD % 32 == 8 ? HD : HD + 8;
  static constexpr int kVS = HD + 4;
  static constexpr int kKS2 = 2 * HD + (48 - 2 * HD % 32) % 32;
  static constexpr int kVS2 = 4 * HD + 8;
  static constexpr int kQ = kBQ * kKS;
  static constexpr int kK = kBK * kKS;
  static constexpr int kV = kBK * kVS;
  // mma.sync: K and V in hi/lo quads; wgmma: K hi, K lo, V^T hi, V^T lo,
  // each kBK x HD TF32 in 128-byte swizzled rows, 1024-byte aligned
  static constexpr int kK2 = kWg ? kBK * HD : kBK * kKS2;
  static constexpr int kV2 = kWg ? kBK * HD : kBK / 2 * kVS2;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kStages * (kK + kV)) +
      (kWg ? sizeof(float) * (2 * kK2 + 2 * kV2) + 1024
           : sizeof(float) * (kK2 + kV2));
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

// x = hi + lo, both TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a.b, m16n8k8, TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p += a.b by split TF32, a and b already split (b = {hi0, hi1, lo0,
// lo1} as shared memory holds it), the small terms first
__device__ __forceinline__ void mma3(float (&p)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint4 b) {
  mma(p, al, b.x, b.y);
  mma(p, ah, b.z, b.w);
  mma(p, ah, b.x, b.y);
}

// a fragment's four f32 values as hi/lo TF32 pairs
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
}

// wgmma: a shared-memory matrix descriptor (start address, leading and
// stride byte offsets, 128-byte swizzle), the fences and the products
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulator
// registers across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// d (64 x 32, f32) (+)= A (64 x 8, TF32 registers) . B (8 x 32, shared
// memory, K-major); scale-d 0 on the first product of a chain
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 8, TF32 registers) . B (8 x 64, shared
// memory, K-major); scale-d 0 on the first product of a chain
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 96, f32) (+)= A (64 x 8, TF32 registers) . B (8 x 96, shared
// memory, K-major); scale-d 0 on the first product of a chain
__device__ __forceinline__ void wgmma_n96(float (&d)[12][4],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 8, TF32 registers) . B (8 x 128, shared
// memory, K-major); scale-d 0 on the first product of a chain
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// o (64 x HD) (+)= p (64 x 8) . V^T's k-step
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (HD == 64) wgmma_n64(o, a, db, accumulate);
  else if constexpr (HD == 96) wgmma_n96(o, a, db, accumulate);
  else wgmma_n128(o, a, db, accumulate);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// keys k0 .. k0 + kBK - 1 of K and V into one stage; keys at or past Skv
// are zeros. kAsync: cp.async, 16 bytes a copy, one commit group; else the
// threads load, convert to f32 and store.
template <typename T, int HD, bool kAsync>
__device__ __forceinline__ void load_tile(float* ks, float* vs, const T* kp,
                                          const T* vp, const Args& a,
                                          int k0) {
  using S = Smem<HD>;
  if constexpr (kAsync) {
    constexpr int kChunks = HD / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool ok = k0 + r < a.Skv;
      const int64_t row = ok ? k0 + r : 0;
      cp_async16(ks + r * S::kKS + c, kp + row * a.kss + c, ok ? 16 : 0);
      cp_async16(vs + r * S::kVS + c, vp + row * a.vss + c, ok ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      float x = 0.f, y = 0.f;
      if (k0 + r < a.Skv) {
        x = to_f32(kp[(k0 + r) * a.kss + c]);
        y = to_f32(vp[(k0 + r) * a.vss + c]);
      }
      ks[r * S::kKS + c] = x;
      vs[r * S::kVS + c] = y;
    }
  }
}

// the f32 tile of one stage split into TF32 hi/lo, in the layouts of
// Smem, by every thread of the block
template <int HD>
__device__ __forceinline__ void split_tile(const float* ks, const float* vs,
                                           float* k2, float* v2) {
  using S = Smem<HD>;
  constexpr int kQuads = HD / 4;  // 4 depths (K) or 4 columns (V) an item
  for (int i = threadIdx.x; i < kBK * kQuads; i += kThreads) {
    const int key = i / kQuads, c = (i % kQuads) * 4;
    const float4 x = *reinterpret_cast<const float4*>(ks + key * S::kKS + c);
    uint32_t h[4], l[4];
    split4({x.x, x.y, x.z, x.w}, h, l);
    float* dst = k2 + key * S::kKS2 + 2 * c;  // pairs c / 2 and c / 2 + 1
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], l[0], l[1]);
    *reinterpret_cast<uint4*>(dst + 4) = make_uint4(h[2], h[3], l[2], l[3]);
  }
  for (int i = threadIdx.x; i < kBK / 2 * kQuads; i += kThreads) {
    const int kp = i / kQuads, c = (i % kQuads) * 4;
    const float4 x =
        *reinterpret_cast<const float4*>(vs + 2 * kp * S::kVS + c);
    const float4 y =
        *reinterpret_cast<const float4*>(vs + (2 * kp + 1) * S::kVS + c);
    uint32_t xh[4], xl[4], yh[4], yl[4];
    split4({x.x, x.y, x.z, x.w}, xh, xl);
    split4({y.x, y.y, y.z, y.w}, yh, yl);
    uint4* dst = reinterpret_cast<uint4*>(v2 + kp * S::kVS2 + 4 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[e] = make_uint4(xh[e], yh[e], xl[e], yl[e]);
  }
}

// the float offset of row r's 16-byte chunk c in 128-byte rows, XORed by
// the row as the wgmma 128-byte swizzle reads it
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 32 + ((c ^ (r & 7)) << 2);
}

// the same for wgmma: K hi/lo as HD / 32 column blocks of kBK rows of 32
// depths (K-major), V^T hi/lo as HD rows of kBK keys (K-major), a k-step's
// keys 8n .. 8n + 7 in the order 0, 2, 4, 6, 1, 3, 5, 7 that p's A
// fragment names them (logical column t is key 8n + 2t, t + 4 is 8n + 2t +
// 1); then the async proxy is fenced for the products' reads
template <int HD>
__device__ __forceinline__ void split_tile_wg(const float* ks,
                                              const float* vs, float* khi,
                                              float* klo, float* vhi,
                                              float* vlo) {
  using S = Smem<HD>;
  constexpr int kQuads = HD / 4;
  for (int i = threadIdx.x; i < kBK * kQuads; i += kThreads) {
    const int key = i / kQuads, d = (i % kQuads) * 4;
    const float4 x = *reinterpret_cast<const float4*>(ks + key * S::kKS + d);
    uint32_t h[4], l[4];
    split4({x.x, x.y, x.z, x.w}, h, l);
    const int off = (d >> 5) * (kBK * 32) + swizzled(key, (d & 31) >> 2);
    *reinterpret_cast<uint4*>(khi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(klo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  for (int i = threadIdx.x; i < HD * (kBK / 4); i += kThreads) {
    const int d = i % HD, c = i / HD;  // chunk c: keys 8(c / 2) + 2e + c % 2
    const float* src = vs + (8 * (c >> 1) + (c & 1)) * S::kVS + d;
    uint32_t h[4], l[4];
    split4({src[0], src[2 * S::kVS], src[4 * S::kVS], src[6 * S::kVS]}, h,
           l);
    const int off = swizzled(d, c);
    *reinterpret_cast<uint4*>(vhi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(vlo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T, int HD, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(Args a) {
  using S = Smem<HD>;
  constexpr int KSTEPS = HD / 8;  // k-steps of q.k^T, n-tiles of p.v
  constexpr int NT = kBK / 8;     // n-tiles of q.k^T, k-steps of p.v
  constexpr int CS = kChain < KSTEPS ? kChain : KSTEPS;  // chained k-steps
  static_assert(KSTEPS % CS == 0, "uneven k-step chains");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S::kQ;                // f32 stages
  float* Vs = Ks + kStages * S::kK;
  // the tile in hi/lo (wgmma: from a 1024-byte boundary)
  float* K2 = Vs + kStages * S::kV;
  if constexpr (S::kWg) {
    const uint32_t at =
        static_cast<uint32_t>(__cvta_generic_to_shared(K2));
    K2 += ((1024 - at % 1024) % 1024) / sizeof(float);
  }
  float* V2 = K2 + (S::kWg ? 2 : 1) * S::kK2;
  const uint32_t sK2 = static_cast<uint32_t>(__cvta_generic_to_shared(K2));
  const uint32_t sV2 = static_cast<uint32_t>(__cvta_generic_to_shared(V2));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int r0 = q0 + 16 * warp;  // this warp's first row
  const int hk = h / a.group;
  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;
  T* op = static_cast<T*>(a.o) + b * a.osb + h * a.osh;

  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  if (n_tiles > 0) load_tile<T, HD, kAsync>(Ks, Vs, kp, vp, a, 0);

  // the block's q rows, cast to f32 and scaled, rows past Sq zero; the
  // first barrier of the walk publishes them
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    Qs[r * S::kKS + d] =
        q0 + r < a.Sq ? to_f32(qp[(q0 + r) * a.qss + d]) * a.scale : 0.f;
  }
  const float* qw = Qs + 16 * warp * S::kKS;  // this warp's 16 rows
  // o[n][0..1]: row g, columns 8n + 2t, 8n + 2t + 1; o[n][2..3]: row g + 8
  float o[KSTEPS][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;
  // the rows a product spans: a warp's 16 (mma.sync), its warpgroup's 64
  // (wgmma, whose products the 4 warps make together)
  const int p0 = S::kWg ? q0 + 64 * (warp >> 2) : r0;
  const int p_last = min(p0 + (S::kWg ? 63 : 15), a.Sq - 1);  // < p0: none

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    if constexpr (kStages == 2) {
      if (j + 1 < n_tiles) {
        load_tile<T, HD, kAsync>(Ks + ((j + 1) & 1) * S::kK,
                                 Vs + ((j + 1) & 1) * S::kV, kp, vp, a,
                                 k0 + kBK);
        if constexpr (kAsync) cp_async_wait<1>();
      } else if constexpr (kAsync) {
        cp_async_wait<0>();
      }
    } else if constexpr (kAsync) {
      cp_async_wait<0>();
    }
    // tile j's f32 stage is in for every thread, and every warp is done
    // with tile j - 1's hi/lo
    __syncthreads();
    if constexpr (S::kWg)
      split_tile_wg<HD>(Ks + (j % kStages) * S::kK,
                        Vs + (j % kStages) * S::kV, K2, K2 + S::kK2, V2,
                        V2 + S::kV2);
    else
      split_tile<HD>(Ks + (j % kStages) * S::kK, Vs + (j % kStages) * S::kV,
                     K2, V2);
    __syncthreads();  // the hi/lo tile is in; the f32 stage is free
    if constexpr (kStages == 1) {
      if (j + 1 < n_tiles)
        load_tile<T, HD, kAsync>(Ks, Vs, kp, vp, a, k0 + kBK);
    }
    if (p_last < p0 || (a.causal && k0 > p_last)) continue;
    // s[n]: rows g, g + 8 x keys k0 + 8n + 2t, + 1 (accumulator layout)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (S::kWg) {
      // chains of CS k-steps into two accumulators in turn: chain c runs
      // while chain c - 1's sum is added to s, so the tensor cores are
      // never left waiting for the adds
      constexpr int kChains = KSTEPS / CS;
      float acc[2][NT][4];
      uint32_t ah[2][CS][4], al[2][CS][4];
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch) {
        const int b = ch & 1;  // chain ch - 2's buffers, done with
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          // q's A fragment in the natural depth order: (g, 8kk + t),
          // (g + 8, 8kk + t), (g, 8kk + t + 4), (g + 8, 8kk + t + 4)
          const float* qk = qw + 8 * (ch * CS + c) + t;
          split4({qk[g * S::kKS], qk[(g + 8) * S::kKS], qk[g * S::kKS + 4],
                  qk[(g + 8) * S::kKS + 4]}, ah[b][c], al[b][c]);
        }
        wgmma_fence();
        fence_regs(acc[b]);
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          const int kk = ch * CS + c;
          const uint32_t at = (kk >> 2) * (kBK * 128) + (kk & 3) * 32;
          const uint64_t hi = desc(sK2 + at, 16, 1024);
          const uint64_t lo = desc(sK2 + 4 * S::kK2 + at, 16, 1024);
          wgmma_n32(acc[b], al[b][c], hi, c > 0);
          wgmma_n32(acc[b], ah[b][c], lo, 1);
          wgmma_n32(acc[b], ah[b][c], hi, 1);
        }
        wgmma_commit();
        if (ch > 0) {
          wgmma_wait<1>();  // chain ch - 1 is done
          fence_regs(acc[b ^ 1]);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += acc[b ^ 1][n][e];
        }
      }
      wgmma_wait<0>();
      fence_regs(acc[(kChains - 1) & 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += acc[(kChains - 1) & 1][n][e];
    } else {
#pragma unroll
      for (int k0s = 0; k0s < KSTEPS; k0s += CS) {
        // q's A fragments, (row, logical column) in register order (g, t),
        // (g + 8, t), (g, t + 4), (g + 8, t + 4): depths 8kk + 2t and
        // 8kk + 2t + 1 of rows g and g + 8
        uint32_t ah[CS][4], al[CS][4];
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          const int kk = k0s + c;
          const float2 qg = *reinterpret_cast<const float2*>(
              qw + g * S::kKS + 8 * kk + 2 * t);
          const float2 qg8 = *reinterpret_cast<const float2*>(
              qw + (g + 8) * S::kKS + 8 * kk + 2 * t);
          split4({qg.x, qg8.x, qg.y, qg8.y}, ah[c], al[c]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < CS; ++c)
            mma3(p, ah[c], al[c],
                 *reinterpret_cast<const uint4*>(
                     K2 + (8 * n + g) * S::kKS2 + 4 * (4 * (k0s + c) + t)));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += p[e];
        }
      }
    }
    const bool edge = k0 + kBK > a.Skv || (a.causal && k0 + kBK - 1 > r0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * n + 2 * t + e;
          if (edge && (col >= a.Skv || (a.causal && r < col)))
            s[n][2 * i + e] = kNegInf;
          mx = fmaxf(mx, s[n][2 * i + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * i + e] - m_new);
          s[n][2 * i + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < KSTEPS; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }
    // o += p.v, the tile's products chained from zero: k-step n is S's
    // n-tile n, whose accumulator fragment is p's A fragment once its keys
    // are named in the same order in V's B fragment: logical column t is
    // key 8n + 2t, t + 4 is 8n + 2t + 1 (key pair 4n + t)
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      split4({s[n][0], s[n][2], s[n][1], s[n][3]}, ph[n], pl[n]);
    if constexpr (S::kWg) {
      float ot[KSTEPS][4];
      wgmma_fence();
      fence_regs(ot);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint64_t hi = desc(sV2 + n * 32, 16, 1024);
        const uint64_t lo = desc(sV2 + 4 * S::kV2 + n * 32, 16, 1024);
        wgmma_pv<HD>(ot, pl[n], hi, n > 0);
        wgmma_pv<HD>(ot, ph[n], lo, 1);
        wgmma_pv<HD>(ot, ph[n], hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ot);
#pragma unroll
      for (int d = 0; d < KSTEPS; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] += ot[d][e];
    } else {
#pragma unroll
      for (int d = 0; d < KSTEPS; ++d) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma3(p, ph[n], pl[n],
               *reinterpret_cast<const uint4*>(
                   V2 + (4 * n + t) * S::kVS2 + 4 * (8 * d + g)));
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] += p[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = op + r * a.oss;
#pragma unroll
    for (int n = 0; n < KSTEPS; ++n) {
      store(orow + 8 * n + 2 * t, o[n][2 * i] / den);
      store(orow + 8 * n + 2 * t + 1, o[n][2 * i + 1] / den);
    }
  }
}

template <typename T, int HD, bool kAsync>
cudaError_t launch(const Args& a, int Hq, int B, int nq, cudaStream_t st) {
  static bool configured = false;  // the opt-in above 48 KiB, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD, kAsync>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<HD>::kBytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  flash_attention_kernel<T, HD, kAsync>
      <<<dim3(Hq, B, nq), kThreads, Smem<HD>::kBytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kAsync>
cudaError_t launch_hd(int hd, const Args& a, int Hq, int B, int nq,
                      cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8, kAsync>(a, Hq, B, nq, st);
    case 16: return launch<T, 16, kAsync>(a, Hq, B, nq, st);
    case 32: return launch<T, 32, kAsync>(a, Hq, B, nq, st);
    case 64: return launch<T, 64, kAsync>(a, Hq, B, nq, st);
    case 96: return launch<T, 96, kAsync>(a, Hq, B, nq, st);
    case 128: return launch<T, 128, kAsync>(a, Hq, B, nq, st);
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
  if (is_bf16) return static_cast<int>(
      launch_hd<__nv_bfloat16, false>(hd, a, Hq, B, nq, st));
  // cp.async copies 16 bytes: every K and V row must start 16-byte aligned
  const bool aligned =
      reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
      (ksb | ksh | kss | vsb | vsh | vss) % 4 == 0;
  const cudaError_t e = aligned
                            ? launch_hd<float, true>(hd, a, Hq, B, nq, st)
                            : launch_hd<float, false>(hd, a, Hq, B, nq, st);
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

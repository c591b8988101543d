// opic_update — the OPIC cash scatter-add, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/opic_update/opic_update.py:41
// (opic_scatter_add, body _kernel at :25): per batch row b, the items
// (rows[b, i], contrib[b, i], mask[b, i]) are walked in tiles of `tile`, in
// order, and every masked item adds its contribution to cash[b, rows[b, i]]
// (a target in [-R, 0) wraps to [0, R), as JAX's indexing does; masked
// items and other targets drop). Contributions to one target accumulate in
// item order, exactly: the f32 sums equal a serial loop over the items.
//
// What bounds it on this card: bytes, and the order. The function must read
// every item's row (8 B), contribution (4 B) and mask (1 B) once and read
// and write each touched target once; at the spend step of the full config
// (one batch row, 8,192 items into 512 slots) that is about 110 KB, some
// 30 ns at 3.35 TB/s. Atomics would be faster but add in a different order
// on every run and would fork the crawl's trajectory.
//
// What the design does about it ("owner computes"): one block per batch
// row walks its tiles in order. The block loads a tile's items into shared
// memory, then every thread scans the tile's items in order and adds those
// whose target it owns (targets t with t mod blockDim == thread). One
// thread per target means no atomics and item order per target; the scan
// reads shared memory by broadcast. A tile whose items are all masked is
// skipped after one barrier. The cash row may be a strided view (the
// url lane order_state[:, 2:]): the kernel takes its row stride. For the
// url lane's cells (R rows of C cells with row-aligned items) the wrapper
// runs R batch rows of C targets, R blocks in parallel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 1024;

__global__ void __launch_bounds__(kThreads)
opic_update_kernel(float* cash, const int64_t* __restrict__ rows,
                   const float* __restrict__ contrib,
                   const bool* __restrict__ mask, int R, int N,
                   int64_t ld, int tile) {
  __shared__ int s_tgt[kMaxTile];
  __shared__ float s_val[kMaxTile];
  const size_t b = blockIdx.x;
  float* crow = cash + b * ld;
  for (int t0 = 0; t0 < N; t0 += tile) {
    const int n = min(tile, N - t0);
    bool any = false;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const size_t o = b * N + t0 + i;
      int tgt = -1;
      if (mask[o]) {
        const int64_t r = rows[o];
        if (r >= -R && r < R) tgt = static_cast<int>(r < 0 ? r + R : r);
      }
      s_tgt[i] = tgt;
      if (tgt >= 0) {
        s_val[i] = contrib[o];
        any = true;
      }
    }
    if (!__syncthreads_or(any)) continue;  // an all-masked tile
    for (int i = 0; i < n; ++i) {
      const int tgt = s_tgt[i];
      if (tgt >= 0 && tgt % kThreads == static_cast<int>(threadIdx.x)) {
        crow[tgt] = crow[tgt] + s_val[i];
      }
    }
    __syncthreads();  // the next tile overwrites the shared items
  }
}

}  // namespace

extern "C" int opic_update_launch(void* cash, const void* rows,
                                  const void* contrib, const void* mask,
                                  int B, int R, int N, int ld, int tile,
                                  void* stream) {
  if (B > 0 && N > 0) {
    if (tile < 1 || tile > kMaxTile) return static_cast<int>(
        cudaErrorInvalidValue);
    opic_update_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(cash), static_cast<const int64_t*>(rows),
        static_cast<const float*>(contrib), static_cast<const bool*>(mask),
        R, N, static_cast<int64_t>(ld), tile);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* opic_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

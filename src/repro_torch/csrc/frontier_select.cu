// frontier_select — the URL allocator's pop, written by hand for Hopper
// (sm_90a), and select_harvest, the same pop fused with the url-lane cash
// harvest.
//
// Replaces the TPU kernel repro/kernels/frontier_select/frontier_select.py:85
// (frontier_select, body _kernel at :29): per frontier row, k rounds of a
// masked max with the first index achieving it; the popped cells leave the
// queue (priority NEG, valid false). select_harvest replaces
// frontier_select.py:116 (select_harvest_kernel, body _harvest_kernel at
// :56): the same pop, plus each popped cell's cash read from the lane
// `table` (0 where the lane is masked) and that cell of the table zeroed.
//
// What bounds it on this card: bytes. A launch must read every cell's
// priority (4 B) and valid flag (1 B) once. At the full config (512 rows of
// 4096 cells, k = 1) that is 10.5 MB, about 3 us at 3.35 TB/s; the
// arithmetic is one compare per cell per round.
//
// What the design does about it: one block per row; the threads stride over
// the row so that neighbouring threads read neighbouring cells, and the
// (max, lowest index) reduction runs in warp shuffles and then shared
// memory. Round j takes the best cell that lies strictly after round j-1's
// pick in the order (key descending, index ascending), so no popped set is
// kept and the picks equal a stable descending sort of the keys. Where the
// TPU kernel wrote whole rows of pri' and valid' back, this one writes only
// the k popped cells, in place in the caller's tensors. For k > 1 each round
// reads the row again (from L2); the main path pops k = 1. The harvest adds
// one 4-byte read and one 4-byte write per popped cell, in the same pass as
// the pops; the table is a view with its own row stride (the lane is
// order_state[:, 2:], whose rows are 2 + C floats apart), so no copy is
// made.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3e38f;

// (v, i) beats (bv, bi): larger key, or the same key at a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <bool kHarvest>
__global__ void __launch_bounds__(kThreads)
frontier_select_kernel(const int64_t* __restrict__ url, float* pri,
                       bool* valid, int C, int k, int64_t* sel_url,
                       float* sel_pri, bool* sel_mask, int64_t* sel_idx,
                       float* table, int64_t ld_table, float* cash) {
  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  __shared__ float best_v;
  __shared__ int best_i;
  const size_t row = blockIdx.x;
  const float* prow = pri + row * C;
  const bool* vrow = valid + row * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float prev_v = INFINITY;  // round 0: every cell lies after the start
  int prev_i = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;   // (-inf, INT_MAX): no candidate yet
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float v = vrow[c] ? prow[c] : kNeg;
      const bool after = v < prev_v || (v == prev_v && c > prev_i);
      if (after && better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      s_v[warp] = bv;
      s_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_v[lane] : -INFINITY;
      bi = lane < kWarps ? s_i[lane] : INT_MAX;
      warp_best(bv, bi);
      if (lane == 0) {
        const bool ok = bv > kNeg * 0.5f;
        const size_t o = row * k + j;
        sel_pri[o] = bv;
        sel_mask[o] = ok;
        sel_idx[o] = bi;
        sel_url[o] = ok ? url[row * C + bi] : 0;
        best_v = bv;
        best_i = bi;
      }
    }
    __syncthreads();
    prev_v = best_v;
    prev_i = best_i;
  }
  // the pops, after every round has read the row as it was at launch
  if (threadIdx.x == 0) {
    for (int j = 0; j < k; ++j) {
      const size_t o = row * k + j;
      const bool ok = sel_mask[o];
      if (ok) {
        pri[row * C + sel_idx[o]] = kNeg;
        valid[row * C + sel_idx[o]] = false;
      }
      if constexpr (kHarvest) {
        float* cell = table + row * ld_table + sel_idx[o];
        cash[o] = ok ? *cell : 0.0f;
        if (ok) *cell = 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" int frontier_select_launch(const void* url, void* pri, void* valid,
                                      void* sel_url, void* sel_pri,
                                      void* sel_mask, void* sel_idx, int R,
                                      int C, int k, void* stream) {
  if (R > 0) {
    frontier_select_kernel<false><<<R, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(url), static_cast<float*>(pri),
        static_cast<bool*>(valid), C, k, static_cast<int64_t*>(sel_url),
        static_cast<float*>(sel_pri), static_cast<bool*>(sel_mask),
        static_cast<int64_t*>(sel_idx), nullptr, 0, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int select_harvest_launch(const void* url, void* pri, void* valid,
                                     void* table, void* sel_url,
                                     void* sel_pri, void* sel_mask,
                                     void* sel_idx, void* cash, int R, int C,
                                     int k, int ld_table, void* stream) {
  if (R > 0) {
    frontier_select_kernel<true><<<R, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(url), static_cast<float*>(pri),
        static_cast<bool*>(valid), C, k, static_cast<int64_t*>(sel_url),
        static_cast<float*>(sel_pri), static_cast<bool*>(sel_mask),
        static_cast<int64_t*>(sel_idx), static_cast<float*>(table),
        static_cast<int64_t>(ld_table), static_cast<float*>(cash));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frontier_select_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// valid flag (1 B) and the priority (4 B) of each valid cell; an invalid
// cell's key is NEG whatever its priority. At the full config (512 rows of
// 4096 cells, k = 1) the crawl's frontier holds 1-2% valid cells, so that is
// ~2.2 MB, 0.65 us at 3.35 TB/s; rows with every cell valid would need
// 10.5 MB, 3.13 us. The harvest adds a few KB. The arithmetic is two
// compares per cell per round.
//
// What the design does about it:
// - Wide, independent loads. A row is cut into chunks of kCells cells per
//   thread. On the vector path (C % 4 == 0, priorities 16-byte and flags
//   4-byte aligned; the wrapper decides from the pointers and C) neighbouring
//   threads read neighbouring 32-bit words of four flags, then the float4s
//   of priorities whose group holds a valid cell; on the scalar path (any
//   other C or offset) neighbouring threads read neighbouring cells, a
//   priority only where its flag is set. A thread issues all its flag loads
//   at once, then all its priority loads: two round trips to memory, and
//   the priority sectors of empty groups are never read.
// - One read of the row for any k. Where one chunk covers the row (C up to
//   kMaxRowThreads x kCells = 8192) the keys stay in registers for all k
//   rounds; for longer rows they go to shared memory on the first round
//   (C up to kSharedKeyBytes / 4 = 51,200 cells a row); only beyond that
//   does each round read the row again from device memory (and there the
//   pops are written after the last round, so later rounds see the row as
//   it was at launch). Round j takes the best cell that lies strictly
//   after round j-1's pick in the pop order (key descending, index
//   ascending), so nothing is marked and the picks, the masked lanes'
//   indices included, equal a stable descending sort of the keys.
// - Each round is one arg-max over the row: the thread's cells, a warp
//   butterfly of shuffles, then (rows of more than 32 threads) one step
//   through shared memory, double-buffered by round so a round costs one
//   barrier. The thread whose chunk holds the winning cell writes the
//   round's outputs, the pop and the harvest; there is no serial tail.
// - Block shape: the row gets the fewest threads, a power of two from 32
//   to kMaxRowThreads, whose chunk covers it (256 at C = 4096), and a block
//   holds kBlockThreads / that many rows when they are fewer (8 rows of 64
//   cells, or of 512, in one 256-thread block). Registers are capped at 64
//   a thread, so four 256-thread rows fit a SM and the 512 rows of the
//   full config are in flight at once on either path.
//
// Where the TPU kernel wrote whole rows of pri' and valid' back, this one
// writes only the k popped cells, in place in the caller's tensors; the
// table is a view with its own row stride (the lane is order_state[:, 2:],
// whose rows are 2 + C floats apart), so no copy is made.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (tools/frontier_select_variants.py: every copy of the inputs restored
// before each graph replay; cold: one call on each of 48 copies, the L2
// flushed first): on the frontiers captured from CONFIG crawls, 512 x 4096,
// k = 1, 1.0-1.7% valid, frontier_select 4.53 us and select_harvest 4.69 us
// a call cold, 4.15 and 4.51 us a launch inside the crawl, where the
// earlier one-block-a-row kernel took 7.37 and 8.01 cold, 7.70 and 7.74 in
// the crawl, and torch.topk 87-92 in a graph; on rows drawn 60% valid, 7.21
// us cold against 10.34. At k = 8 (60% valid), 22.3 us against 27.1: each
// round waits for its winner's url load.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// The design's choices (tools/frontier_select_variants.py times each one
// changed against the rest).
constexpr int kVecPerThread = 4;     // 4-cell groups a thread holds a chunk
constexpr int kBlockThreads = 256;   // least threads a block
constexpr int kMaxRowThreads = 512;  // most threads a row
constexpr int kSharedKeyBytes = 200 * 1024;  // a block's keys in shared mem
// Registers are capped so that this many threads fit a SM (65536 / 1024 =
// 64 a thread). The vector path needs fewer at C = 4096; the scalar path
// would take 80, so that only three 256-thread rows fit a SM and the 512
// rows of the full config would run in two waves.
constexpr int kThreadsPerSM = 1024;
// A thread loads a priority (a float4 of them on the vector path) only
// where its flag (one of the four) is set: the crawl's frontier rows are
// mostly empty, so most priority sectors are never read.
constexpr bool kSkipInvalid = true;

constexpr int kCells = 4 * kVecPerThread;     // cells a thread holds a chunk
constexpr int kMaxThreads =
    kMaxRowThreads > kBlockThreads ? kMaxRowThreads : kBlockThreads;
constexpr float kNeg = -3e38f;

enum Mode : int { kRegisters = 0, kShared = 1, kGlobal = 2 };

struct Args {
  const int64_t* url;
  float* pri;
  bool* valid;
  int64_t* sel_url;
  float* sel_pri;
  bool* sel_mask;
  int64_t* sel_idx;
  float* table;  // select_harvest only
  int64_t ld_table;
  float* cash;
  int R, C, k, mode;
};

// (v, i) beats (bv, bi): larger key, or the same key at a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// (v, i) comes after (pv, pi) in the pop order.
__device__ __forceinline__ bool after(float v, int i, float pv, int pi) {
  return v < pv || (v == pv && i > pi);
}

// The cell that slot s of thread t holds in the chunk starting at `base`;
// the thread's cells rise with s, and cell c's thread is owner(c).
template <int TPR, bool VEC>
__device__ __forceinline__ int cell_of(int base, int t, int s) {
  if constexpr (VEC) {
    return base + ((s >> 2) * TPR + t) * 4 + (s & 3);
  } else {
    return base + s * TPR + t;
  }
}

template <int TPR, bool VEC>
__device__ __forceinline__ int owner(int c) {
  return VEC ? (c >> 2) % TPR : c % TPR;
}

// A chunk's keys from device memory: the priority where the flag is set,
// NEG where not, -inf past the row's end (beaten by every cell of the row,
// which lie before it).
template <int TPR, bool VEC>
__device__ __forceinline__ void load_chunk(const float* prow,
                                           const bool* vrow, int C, int base,
                                           int t, float (&key)[kCells]) {
  if constexpr (VEC) {
    float4 p[kVecPerThread];
    uint32_t v[kVecPerThread];
#pragma unroll
    for (int m = 0; m < kVecPerThread; ++m) {
      const int c = cell_of<TPR, VEC>(base, t, 4 * m);
      // C % 4 == 0: a group lies wholly inside or outside the row
      v[m] = c < C ? *reinterpret_cast<const uint32_t*>(vrow + c) : 0u;
    }
#pragma unroll
    for (int m = 0; m < kVecPerThread; ++m) {
      const int c = cell_of<TPR, VEC>(base, t, 4 * m);
      if (kSkipInvalid ? v[m] != 0u : c < C) {
        p[m] = *reinterpret_cast<const float4*>(prow + c);
      }
    }
#pragma unroll
    for (int m = 0; m < kVecPerThread; ++m) {
      const bool in = cell_of<TPR, VEC>(base, t, 4 * m) < C;
      const float q[4] = {p[m].x, p[m].y, p[m].z, p[m].w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        key[4 * m + b] =
            in ? (((v[m] >> (8 * b)) & 0xffu) ? q[b] : kNeg) : -INFINITY;
      }
    }
  } else {
    float p[kCells];
    bool v[kCells];
#pragma unroll
    for (int s = 0; s < kCells; ++s) {
      const int c = cell_of<TPR, VEC>(base, t, s);
      v[s] = c < C ? vrow[c] : false;
    }
#pragma unroll
    for (int s = 0; s < kCells; ++s) {
      const int c = cell_of<TPR, VEC>(base, t, s);
      if (kSkipInvalid ? v[s] : c < C) p[s] = prow[c];
    }
#pragma unroll
    for (int s = 0; s < kCells; ++s) {
      key[s] = cell_of<TPR, VEC>(base, t, s) < C ? (v[s] ? p[s] : kNeg)
                                                 : -INFINITY;
    }
  }
}

template <int TPR, bool VEC>
__device__ __forceinline__ void store_shared(float* srow, int C, int base,
                                             int t,
                                             const float (&key)[kCells]) {
#pragma unroll
  for (int m = 0; m < kVecPerThread; ++m) {
    if constexpr (VEC) {
      const int c = cell_of<TPR, VEC>(base, t, 4 * m);
      if (c < C) {
        *reinterpret_cast<float4*>(srow + c) = make_float4(
            key[4 * m], key[4 * m + 1], key[4 * m + 2], key[4 * m + 3]);
      }
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = cell_of<TPR, VEC>(base, t, 4 * m + b);
        if (c < C) srow[c] = key[4 * m + b];
      }
    }
  }
}

template <int TPR, bool VEC>
__device__ __forceinline__ void load_shared(const float* srow, int C,
                                            int base, int t,
                                            float (&key)[kCells]) {
#pragma unroll
  for (int m = 0; m < kVecPerThread; ++m) {
    if constexpr (VEC) {
      const int c = cell_of<TPR, VEC>(base, t, 4 * m);
      const float4 q = c < C ? *reinterpret_cast<const float4*>(srow + c)
                             : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                           -INFINITY);
      key[4 * m] = q.x;
      key[4 * m + 1] = q.y;
      key[4 * m + 2] = q.z;
      key[4 * m + 3] = q.w;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = cell_of<TPR, VEC>(base, t, 4 * m + b);
        key[4 * m + b] = c < C ? srow[c] : -INFINITY;
      }
    }
  }
}

// The thread's best cell of a chunk among those after (pv, pi), folded
// into (bv, bi), which holds cells of earlier chunks.
template <int TPR, bool VEC>
__device__ __forceinline__ void scan(const float (&key)[kCells], int base,
                                     int t, float pv, int pi, float& bv,
                                     int& bi) {
#pragma unroll
  for (int s = 0; s < kCells; ++s) {
    const int c = cell_of<TPR, VEC>(base, t, s);
    if (after(key[s], c, pv, pi) && better(key[s], c, bv, bi)) {
      bv = key[s];
      bi = c;
    }
  }
}

// Round 0's scan: every cell is a candidate, and a thread's cells rise
// with the slot, so the first of the largest keys wins by a plain compare
// and only its slot is tracked.
template <int TPR, bool VEC>
__device__ __forceinline__ void scan_first(const float (&key)[kCells],
                                           int base, int t, float& bv,
                                           int& bi) {
  float v = key[0];
  int bs = 0;
#pragma unroll
  for (int s = 1; s < kCells; ++s) {
    if (key[s] > v) {
      v = key[s];
      bs = s;
    }
  }
  if (base == 0 || v > bv) {  // an earlier chunk's cell wins a tie
    bv = v;
    bi = cell_of<TPR, VEC>(base, t, bs);
  }
}

// The row's best (v, i), left in every thread of the row. Round j uses
// buffer j & 1, so one barrier a round keeps the buffers apart.
template <int TPR>
__device__ __forceinline__ void row_best(float& v, int& i, int j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    __shared__ float s_v[2][kMaxThreads / 32];
    __shared__ int s_i[2][kMaxThreads / 32];
    const int warp = threadIdx.x >> 5;
    const int b = j & 1;
    if ((threadIdx.x & 31) == 0) {
      s_v[b][warp] = v;
      s_i[b][warp] = i;
    }
    __syncthreads();
    const int first = warp & ~(kWarps - 1);  // the row's first warp
    v = s_v[b][first];
    i = s_i[b][first];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_v[b][first + w], s_i[b][first + w], v, i)) {
        v = s_v[b][first + w];
        i = s_i[b][first + w];
      }
    }
  }
}

template <int TPR, bool VEC, bool kHarvest>
__device__ __forceinline__ void pop(const Args& a) {
  extern __shared__ __align__(16) float s_keys[];
  const int t = threadIdx.x % TPR;
  const int rib = threadIdx.x / TPR;  // row in the block
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / TPR)
                      + rib;
  const bool live = row < a.R;
  const int C = a.C;
  const int64_t off = live ? row * C : 0;
  const float* prow = a.pri + off;
  const bool* vrow = a.valid + off;
  float* srow = s_keys + static_cast<size_t>(rib) * C;
  constexpr int kChunk = TPR * kCells;
  float key[kCells];
  if (a.mode == kRegisters) {
    if (live) {
      load_chunk<TPR, VEC>(prow, vrow, C, 0, t, key);
    } else {
#pragma unroll
      for (int s = 0; s < kCells; ++s) key[s] = -INFINITY;
    }
  }
  float pv = INFINITY;  // round 0: every cell lies after the start
  int pi = -1;
  for (int j = 0; j < a.k; ++j) {
    float bv = -INFINITY;  // (-inf, INT_MAX): no candidate yet
    int bi = INT_MAX;
    if (a.mode == kRegisters) {
      if (j == 0) {
        scan_first<TPR, VEC>(key, 0, t, bv, bi);
      } else {
        scan<TPR, VEC>(key, 0, t, pv, pi, bv, bi);
      }
    } else if (live) {
      for (int base = 0; base < C; base += kChunk) {
        if (a.mode == kShared && j > 0) {
          load_shared<TPR, VEC>(srow, C, base, t, key);
        } else {
          load_chunk<TPR, VEC>(prow, vrow, C, base, t, key);
          if (a.mode == kShared) store_shared<TPR, VEC>(srow, C, base, t, key);
        }
        if (j == 0) {
          scan_first<TPR, VEC>(key, base, t, bv, bi);
        } else {
          scan<TPR, VEC>(key, base, t, pv, pi, bv, bi);
        }
      }
    }
    row_best<TPR>(bv, bi, j);
    if (live && owner<TPR, VEC>(bi) == t) {
      const bool ok = bv > kNeg * 0.5f;
      const int64_t o = row * a.k + j;
      a.sel_pri[o] = bv;
      a.sel_mask[o] = ok;
      a.sel_idx[o] = bi;
      a.sel_url[o] = ok ? a.url[off + bi] : 0;
      if constexpr (kHarvest) {
        float* cell = a.table + row * a.ld_table + bi;
        a.cash[o] = ok ? *cell : 0.0f;
        if (ok) *cell = 0.0f;
      }
      if (ok && a.mode != kGlobal) {
        a.pri[off + bi] = kNeg;
        a.valid[off + bi] = false;
      }
    }
    pv = bv;
    pi = bi;
  }
  if (a.mode == kGlobal) {
    // the pops, after every round has read the row as it was at launch
    __syncthreads();
    for (int j = t; live && j < a.k; j += TPR) {
      const int64_t o = row * a.k + j;
      if (a.sel_mask[o]) {
        a.pri[off + a.sel_idx[o]] = kNeg;
        a.valid[off + a.sel_idx[o]] = false;
      }
    }
  }
}

template <int TPR>
constexpr int block_threads() {
  return TPR > kBlockThreads ? TPR : kBlockThreads;
}

template <int TPR>
constexpr int min_blocks() {
  return kThreadsPerSM / block_threads<TPR>() > 1
             ? kThreadsPerSM / block_threads<TPR>() : 1;
}

template <int TPR, bool VEC>
__global__ void __launch_bounds__(block_threads<TPR>(), min_blocks<TPR>())
frontier_select_kernel(const Args a) {
  pop<TPR, VEC, false>(a);
}

template <int TPR, bool VEC>
__global__ void __launch_bounds__(block_threads<TPR>(), min_blocks<TPR>())
select_harvest_kernel(const Args a) {
  pop<TPR, VEC, true>(a);
}

template <int TPR, bool kHarvest>
int launch_rows(Args a, int vec, cudaStream_t stream) {
  constexpr int kThreads = block_threads<TPR>();
  constexpr int kRows = kThreads / TPR;
  const int64_t keys = static_cast<int64_t>(kRows) * a.C * sizeof(float);
  a.mode = a.C <= TPR * kCells ? kRegisters
           : keys <= kSharedKeyBytes ? kShared : kGlobal;
  const size_t smem = a.mode == kShared ? static_cast<size_t>(keys) : 0;
  void (*kern)(const Args);
  if constexpr (kHarvest) {
    kern = vec ? &select_harvest_kernel<TPR, true>
               : &select_harvest_kernel<TPR, false>;
  } else {
    kern = vec ? &frontier_select_kernel<TPR, true>
               : &frontier_select_kernel<TPR, false>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<(a.R + kRows - 1) / kRows, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHarvest>
int launch(const Args& a, int vec, void* stream) {
  if (a.R <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  int tpr = 32;
  while (tpr < kMaxRowThreads && tpr * kCells < a.C) tpr *= 2;
  switch (tpr) {
    case 32: return launch_rows<32, kHarvest>(a, vec, st);
    case 64: return launch_rows<64, kHarvest>(a, vec, st);
    case 128: return launch_rows<128, kHarvest>(a, vec, st);
    case 256: return launch_rows<256, kHarvest>(a, vec, st);
    case 512: return launch_rows<512, kHarvest>(a, vec, st);
    default: return launch_rows<kMaxRowThreads, kHarvest>(a, vec, st);
  }
}

}  // namespace

// vec: 1 for the vector path (C % 4 == 0, pri 16-byte and valid 4-byte
// aligned), 0 for the scalar path; the wrapper decides.
extern "C" int frontier_select_launch(const void* url, void* pri, void* valid,
                                      void* sel_url, void* sel_pri,
                                      void* sel_mask, void* sel_idx, int R,
                                      int C, int k, int vec, void* stream) {
  const Args a{static_cast<const int64_t*>(url), static_cast<float*>(pri),
               static_cast<bool*>(valid), static_cast<int64_t*>(sel_url),
               static_cast<float*>(sel_pri), static_cast<bool*>(sel_mask),
               static_cast<int64_t*>(sel_idx), nullptr, 0, nullptr, R, C, k,
               kRegisters};
  return launch<false>(a, vec, stream);
}

extern "C" int select_harvest_launch(const void* url, void* pri, void* valid,
                                     void* table, void* sel_url,
                                     void* sel_pri, void* sel_mask,
                                     void* sel_idx, void* cash, int R, int C,
                                     int k, int ld_table, int vec,
                                     void* stream) {
  const Args a{static_cast<const int64_t*>(url), static_cast<float*>(pri),
               static_cast<bool*>(valid), static_cast<int64_t*>(sel_url),
               static_cast<float*>(sel_pri), static_cast<bool*>(sel_mask),
               static_cast<int64_t*>(sel_idx), static_cast<float*>(table),
               static_cast<int64_t>(ld_table), static_cast<float*>(cash), R,
               C, k, kRegisters};
  return launch<true>(a, vec, stream);
}

extern "C" const char* frontier_select_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

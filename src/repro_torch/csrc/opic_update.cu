// opic_update — the OPIC cash scatter-add, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/opic_update/opic_update.py:41
// (opic_scatter_add, body _kernel at :25): per batch row b, every masked
// item (rows[b, i], contrib[b, i]) adds its contribution to
// cash[b, rows[b, i]] (a target in [-R, 0) wraps to [0, R), as JAX's
// indexing does; masked items and other targets drop). Contributions to
// one target accumulate in item order, one f32 add at a time: the sums
// equal a serial loop over the items, whatever the TPU kernel's tile (the
// wrapper still checks `tile`, for parity with the plain version).
//
// What bounds it on this card: the launch and the longest per-target
// chain, not bytes. The function must read every item's mask (1 B) and
// each live item's row (8 B) and contribution (4 B) once, and read and
// write each touched target once: about 58 KB at the opic spend (one batch
// row, 8,192 items onto 512 slots), some 17 ns at 3.35 TB/s, against a
// launch of ~2 us. Atomics would add in a different order on every run and
// fork the crawl's trajectory, so each target's adds form one dependent
// chain, as long as that target's item count (~4 cycles an f32 add).
//
// What the design does about it: a stable counting sort of the live items
// by target in shared memory, then one serial walk per target. One block
// per (batch row, range of targets); a row whose targets fit one range
// still gets a few range blocks when there are few rows (the spend runs on
// 8 SMs, not 1). A grid of few blocks gets blocks of 512 threads (one chunk
// holds the spend's 8,192 items), a grid of many 256 (more blocks share a
// SM). tools/opic_update_variants.py times each of these choices, and the
// warp-only path below, against its alternative on the crawl's own
// scatters. Per chunk of 16 items a thread:
//   1. load, coalesced: the mask of every item, the row and contribution
//      of live ones; keep those whose target lies in the block's range and
//      compact them in item order (warp ballots, one scan of the
//      per-warp counts);
//   2. count: S warps each take a contiguous segment of the live items and
//      walk it 32 at a time; __match_any_sync groups the lanes of one
//      target, the group's lowest lane adds the group to the segment's
//      count of that target (no atomics: one writer per (target, segment)),
//      and every lane keeps its rank among the segment's earlier items of
//      its target;
//   3. scan the counts, target-major and segment-minor: each (target,
//      segment) gets its offset in the sorted order;
//   4. place each value at offset + rank: a stable sort by target, ties in
//      item order;
//   5. walk: the thread at the start of each target's run takes the
//      target's cash (loaded in step 1) into a register and adds the run's
//      values in order, a dependent chain as long as the target's item
//      count, then writes it back (once a chunk).
// A chunk with at most 32 live items (the url lane's cells: 512 rows of
// 4,096 cells, a few live items a row) skips steps 2-5: one warp groups
// them by target (__match_any_sync) and each group's first lane adds its
// group's values in lane order, which is item order. Every step but the
// count scan costs in proportion to the live items, and only touched
// targets are read and written, so the cells move kilobytes, not the 8 MB
// table. The loads go in three batches of predicated loads, each in flight
// together (a branch per item would wait out each load's latency in turn):
// the masks; the rows and contributions of masked items; the cash of the
// live items' targets. The cash row may be a strided view (the url lane
// order_state[:, 2:]): the kernel takes its row stride.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPerThread = 16;                       // items a thread loads
constexpr int kMaxRange = 4096;                      // targets a block owns
constexpr int kMaxCounts = 4096;                     // (target, segment) u16
constexpr int kMaxTile = 1024;
constexpr int kMinBlocks = 16;                       // range blocks to aim for
constexpr int kManyBlocks = 132;                     // one a SM: small blocks

struct Smem {
  // byte offsets into the dynamic shared memory, from the chunk, the range
  // and the warps of a block
  int val, sorted, cash, tgt, stgt, rank, cnt, total;
  __host__ __device__ static int max_counts(int range, int warps) {
    return min(kMaxCounts, range * warps);
  }
  __host__ __device__ static Smem of(int chunk, int range, int warps) {
    Smem s;
    int o = 0;
    s.val = o;     o += 4 * chunk;                   // compacted values
    s.sorted = o;  o += 4 * chunk;                   // values, by target
    s.cash = o;    o += 4 * range;                   // touched targets' cash
    s.tgt = o;     o += 2 * chunk;                   // compacted targets
    s.stgt = o;    o += 2 * chunk;                   // targets, sorted
    s.rank = o;    o += 2 * chunk;                   // rank in its segment
    s.cnt = o;     o += 2 * max_counts(range, warps);  // (target, segment)
    s.total = (o + 15) & ~15;
    return s;
  }
};

// loads that every thread issues before it uses any of them: predicated,
// so an unmasked item costs no traffic and no branch splits the batch
__device__ __forceinline__ bool ld_u8_if(const bool* p, bool pred) {
  unsigned v = 0;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q ld.global.nc.u8 %0, [%1];\n}\n"
      : "+r"(v) : "l"(p), "r"(static_cast<int>(pred)));
  return v != 0;
}
__device__ __forceinline__ int64_t ld_s64_if(const int64_t* p, bool pred,
                                             int64_t v) {
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q ld.global.nc.s64 %0, [%1];\n}\n"
      : "+l"(v) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}
__device__ __forceinline__ float ld_f32_if(const float* p, bool pred) {
  float v = 0.f;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}\n"
      : "+f"(v) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}
// the cash row is written by this kernel (an earlier chunk): no .nc
__device__ __forceinline__ float ld_cash_if(const float* p, bool pred) {
  float v = 0.f;
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @q ld.global.f32 %0, [%1];\n}\n"
               : "+f"(v) : "l"(p), "r"(static_cast<int>(pred)) : "memory");
  return v;
}

// exclusive scan of n u16 counts in place, over the whole block. Each
// thread sums a contiguous run, the runs' sums are scanned by shuffles,
// then each thread rewrites its run; on return the whole block sees it.
template <int THREADS>
__device__ void block_scan_u16(uint16_t* a, int n, int* s_part) {
  constexpr int kWarps = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_part[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_part[lane] = w;             // inclusive
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? s_part[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = static_cast<uint16_t>(run);
    run += c;
  }
  __syncthreads();                   // every offset is visible; s_part free
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
opic_update_kernel(float* cash, const int64_t* __restrict__ rows,
                   const float* __restrict__ contrib,
                   const bool* __restrict__ mask, int R, int N, int64_t ld,
                   int range, int chunk) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_part[kWarps];
  __shared__ int s_base[kPerThread * kWarps + 1];
  const Smem L = Smem::of(chunk, range, kWarps);
  float* s_val = reinterpret_cast<float*>(smem + L.val);
  float* s_sorted = reinterpret_cast<float*>(smem + L.sorted);
  float* s_cash = reinterpret_cast<float*>(smem + L.cash);
  uint16_t* s_tgt = reinterpret_cast<uint16_t*>(smem + L.tgt);
  uint16_t* s_stgt = reinterpret_cast<uint16_t*>(smem + L.stgt);
  uint16_t* s_rank = reinterpret_cast<uint16_t*>(smem + L.rank);
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(smem + L.cnt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const size_t b = blockIdx.x;
  const int t0 = blockIdx.y * range;
  const int nt = min(range, R - t0);                 // this block's targets
  float* crow = cash + b * ld + t0;
  const size_t row0 = b * static_cast<size_t>(N);

  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int n = min(chunk, N - c0);
    // 1. load and compact, in item order: item r * THREADS + tid. Three
    // batches of predicated loads, each in flight together: the masks; the
    // rows and contributions of masked items; the cash of the live items'
    // targets (kept in s_cash for the walk)
    const bool* mk = mask + row0 + c0 + tid;
    const int64_t* rw = rows + row0 + c0 + tid;
    const float* cb = contrib + row0 + c0 + tid;
    bool on[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r)
      on[r] = ld_u8_if(mk + r * THREADS, r * THREADS + tid < n);
    int tg[kPerThread];
    float vl[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int64_t x = ld_s64_if(rw + r * THREADS, on[r], R);
      vl[r] = ld_f32_if(cb + r * THREADS, on[r]);
      tg[r] = x >= -R && x < R ? static_cast<int>(x < 0 ? x + R : x) - t0
                               : -1;
    }
    unsigned bal[kPerThread];
    float cv[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const bool live = tg[r] >= 0 && tg[r] < nt;
      cv[r] = ld_cash_if(crow + (live ? tg[r] : 0), live);
      bal[r] = __ballot_sync(0xffffffffu, live);
      if (lane == 0) s_base[r * kWarps + warp] = __popc(bal[r]);
    }
    __syncthreads();
    if (warp == 0) {                                 // scan the warp counts
      constexpr int kPer = kPerThread * kWarps / 32;
      static_assert(kPerThread * kWarps % 32 == 0, "uneven warp counts");
      int c[kPer], sum = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        c[j] = s_base[lane * kPer + j];
        sum += c[j];
      }
      int x = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      int run = x - sum;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s_base[lane * kPer + j] = run;
        run += c[j];
      }
      if (lane == 31) s_base[kPerThread * kWarps] = x;
    }
    __syncthreads();
    const int nl = s_base[kPerThread * kWarps];      // live items
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (bal[r] >> lane & 1u) {
        const int p = s_base[r * kWarps + warp] + __popc(bal[r] & lt);
        s_tgt[p] = static_cast<uint16_t>(tg[r]);
        s_val[p] = vl[r];
        s_cash[tg[r]] = cv[r];         // the same value from every writer
      }
    }
    if (nl <= 32) {                    // few items: one warp, no sort
      __syncthreads();
      if (warp == 0) {
        const int t = lane < nl ? s_tgt[lane] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, t);
        if (t >= 0 && lane == __ffs(peers) - 1) {   // the target's first
          float v = s_cash[t];
          for (unsigned m = peers; m; m &= m - 1) v += s_val[__ffs(m) - 1];
          crow[t] = v;
        }
      }
      __syncthreads();                               // the next chunk
      continue;
    }
    // 2. count: S segments of seg items (a multiple of 32), one warp each
    const int S = max(1, min(min(kWarps, (nl + 31) / 32),
                             Smem::max_counts(range, kWarps) / nt));
    const int seg = ((nl + S - 1) / S + 31) & ~31;
    for (int i = tid; i < nt * S; i += THREADS) s_cnt[i] = 0;
    __syncthreads();
    if (warp < S) {
      const int lo = warp * seg, hi = min(nl, lo + seg);
      for (int p0 = lo; p0 < hi; p0 += 32) {
        const int p = p0 + lane;
        const int t = p < hi ? s_tgt[p] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, t);
        const int leader = __ffs(peers) - 1;
        int c = 0;
        if (lane == leader && t >= 0) c = s_cnt[t * S + warp];
        c = __shfl_sync(0xffffffffu, c, leader);
        if (t >= 0) {
          s_rank[p] = static_cast<uint16_t>(c + __popc(peers & lt));
          if (lane == leader)
            s_cnt[t * S + warp] = static_cast<uint16_t>(c + __popc(peers));
        }
        __syncwarp();                                // counts for the next 32
      }
    }
    __syncthreads();
    // 3. scan: (target, segment) offsets in the sorted order
    block_scan_u16<THREADS>(s_cnt, nt * S, s_part);
    // 4. place, stably
    for (int p = tid; p < nl; p += THREADS) {
      const int t = s_tgt[p];
      const int q = s_cnt[t * S + p / seg] + s_rank[p];
      s_sorted[q] = s_val[p];
      s_stgt[q] = static_cast<uint16_t>(t);
    }
    __syncthreads();
    // 5. walk: the thread at the start of a target's run adds the run in
    // order, one dependent chain, and writes the target's cash once
    for (int p = tid; p < nl; p += THREADS) {
      const int t = s_stgt[p];
      if (p != s_cnt[t * S]) continue;
      const int e = t + 1 < nt ? s_cnt[(t + 1) * S] : nl;
      float v = s_cash[t];
#pragma unroll 8
      for (int j = p; j < e; ++j) v += s_sorted[j];
      crow[t] = v;
    }
    __syncthreads();                                 // the next chunk
  }
}

template <int THREADS>
cudaError_t launch(float* cash, const int64_t* rows, const float* contrib,
                   const bool* mask, int B, int R, int N, int ld, int nr,
                   int range, cudaStream_t st) {
  constexpr int kChunk = THREADS * kPerThread;
  static bool configured = false;                    // the opt-in above 48 KiB
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        opic_update_kernel<THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem::of(kChunk, kMaxRange, THREADS / 32).total);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int chunk = min(kChunk, (N + THREADS - 1) / THREADS * THREADS);
  opic_update_kernel<THREADS>
      <<<dim3(B, nr), THREADS, Smem::of(chunk, range, THREADS / 32).total,
         st>>>(cash, rows, contrib, mask, R, N, static_cast<int64_t>(ld),
               range, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int opic_update_launch(void* cash, const void* rows,
                                  const void* contrib, const void* mask,
                                  int B, int R, int N, int ld, int tile,
                                  void* stream) {
  if (tile < 1 || tile > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N <= 0 || R <= 0) return static_cast<int>(cudaGetLastError());
  // ranges: at most kMaxRange targets; split further while the grid is
  // small, down to 64 targets a block
  int nr = (R + kMaxRange - 1) / kMaxRange;
  if (static_cast<int64_t>(B) * nr < kMinBlocks)
    nr = max(nr, min((R + 63) / 64, (kMinBlocks + B - 1) / B));
  const int range = (R + nr - 1) / nr;
  nr = (R + range - 1) / range;
  if (nr > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // a few blocks (the spend): 512 threads, one chunk of 8,192 items; many
  // (the cells): 256 threads, so that more blocks share a SM
  auto* c = static_cast<float*>(cash);
  auto* r = static_cast<const int64_t*>(rows);
  auto* v = static_cast<const float*>(contrib);
  auto* m = static_cast<const bool*>(mask);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      static_cast<int64_t>(B) * nr < kManyBlocks
          ? launch<512>(c, r, v, m, B, R, N, ld, nr, range, st)
          : launch<256>(c, r, v, m, B, R, N, ld, nr, range, st);
  return static_cast<int>(e);
}

extern "C" const char* opic_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

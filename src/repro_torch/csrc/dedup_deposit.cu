// dedup_deposit — the fused dispatch's Bloom dedup, queued-twin match and
// cash deposit, written by hand for Hopper (sm_90a), on a byte-per-bit
// filter (dedup_deposit_launch) and on a filter packed in 32-bit words
// (dedup_deposit_packed_launch).
//
// Replaces the TPU kernel repro/kernels/dedup_deposit/dedup_deposit.py:105
// (dedup_deposit_kernel, body _kernel at :48, with packed_kernel=False and
// with packed_kernel=True, the packed branch at :65-84): per frontier row,
// the received URLs are walked in tiles of `tile`, in order. Per tile: (1)
// the Bloom probe and insert of the bloom kernel (csrc/bloom.cu, either
// layout): `seen` is "all k bits already set", read after the earlier
// tiles inserted and before this tile does, ANDed with the mask; (2) each
// seen URL is matched against the URLs still queued in its row (f_url where
// f_valid), the lowest such column wins; (3) its value is added to that
// cell of the url lane `table`, in item order; (4) the values of seen URLs
// with no queued twin are summed by a halving tree over the tile's
// power-of-two width, absent lanes +0.0, and added to the row's refund
// (kernels/rowsum.py's tree_sum).
//
// What bounds it on this card: bytes, in scattered accesses. A 16 MiB
// filter row (2 MiB packed) fits no shared memory, so every probe is a byte
// or word at a hashed address of device memory. The function must read
// each lane's mask and write its `seen` (1 B each), read the live URLs (8
// B) and values (4 B), k filter bytes (k words packed) per live URL and the
// bytes it newly sets, and, for a row with a seen URL, its f_valid bytes
// and the queued URLs of its valid cells. The crawl's rows are sparse on
// both sides: ~4 live lanes of 4,096 and 1-2% of the queue valid, and its
// batches re-send URLs still queued, so most of the time went to walking
// empty tiles and to scanning a row's queue cell by cell for each seen URL.
//
// What the design does about it: one block of 256 threads per row. (a) The
// row's mask is read as 16-byte vectors and its live lanes compacted, in
// order, into shared memory (a block scan), 4,096 lanes at a time; `seen`
// is gathered in shared memory and written back as 16-byte vectors, so a
// row with no live lane costs one pass and writes refund 0. (b) Only the
// live lanes are walked, grouped by tile in tile order: probe (every one of
// the k loads issued at once), barrier, insert (only the bits the probe
// found clear, with no second read); two barriers a non-empty tile, none
// for an empty one. (c) At the first tile with a seen URL the row's queue
// is built once in shared memory: f_valid read as 16-byte vectors, the
// valid cells compacted in column order and only their f_url gathered; a
// shared-memory hash keyed by URL keeps the lowest index of each, so a
// seen URL finds its lowest-column twin in a probe or two. A queue of more
// than kQueueCap valid cells is searched kQueueCap columns at a time, in
// column order. (d) One warp applies a tile's deposits in item
// order: lanes holding the same cell are found by __match_any_sync and the
// lowest of them adds the values one by one, in item order, as the plain
// version does. (e) Another warp sums the refund by the same halving tree,
// in registers: the tile's no-twin values sit at their lane positions in a
// zeroed buffer, each lane halves its own positions while the half is 32 or
// wider, then shuffles finish the last five levels; every addition pairs
// the same two positions as tree_sum, with absent lanes +0.0, so the bits
// (and -0.0 -> +0.0) are the same.
// Tiles with no seen URL add nothing, which is exact: the refund starts at
// +0.0 and can never become -0.0. A packed insert is an atomicOr on its
// word, so two URLs of a tile that set different bits of one word both keep
// theirs. The filter and the lane are updated in place; the lane may be a
// strided view (order_state[:, 2:]).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // a row's block
constexpr int kLaneWindow = 4096;  // lanes compacted at a time
constexpr int kMaxTile = 1024;
constexpr int kQueueCap = 1024;   // queued cells in shared memory at a time
constexpr int kHashSlots = 2 * kQueueCap;
constexpr int kMaxWarps = kThreads / 32;

// repro/core/webgraph.py _mix: murmur3-style finalizer on uint32
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t salt) {
  x ^= salt * 0x9E3779B9u + 0x85EBCA6Bu;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// One filter bit at position `pos` of a row: a byte (0 or 1), or bit
// pos & 31 of the row's word pos >> 5 (as in bloom.cu).
template <bool kPacked>
__device__ __forceinline__ bool test_bit(const uint8_t* frow, uint32_t pos) {
  if constexpr (kPacked) {
    return (reinterpret_cast<const uint32_t*>(frow)[pos >> 5] >> (pos & 31)) &
           1u;
  } else {
    return frow[pos] == 1;
  }
}

template <bool kPacked>
__device__ __forceinline__ void set_bit(uint8_t* frow, uint32_t pos) {
  if constexpr (kPacked) {
    uint32_t* w = reinterpret_cast<uint32_t*>(frow) + (pos >> 5);
    const uint32_t bit = 1u << (pos & 31);
    if ((*w & bit) == 0u) atomicOr(w, bit);
  } else {
    if (frow[pos] == 0) frow[pos] = 1;
  }
}

// the same for a bit the probe found clear: no read first (a store, or an
// atomicOr packed, that no one waits for); another URL of the tile may have
// set it meanwhile, which leaves it set either way
template <bool kPacked>
__device__ __forceinline__ void set_new_bit(uint8_t* frow, uint32_t pos) {
  if constexpr (kPacked) {
    atomicOr(reinterpret_cast<uint32_t*>(frow) + (pos >> 5), 1u << (pos & 31));
  } else {
    frow[pos] = 1;
  }
}

// the flags of bytes p .. p + 15 (bool, 0 or 1) below `end` as bits 0-15:
// one 16-byte load where the span is whole and aligned
__device__ __forceinline__ uint32_t flags16(const bool* base, int64_t p,
                                            int64_t end) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(base) + p;
  uint32_t bits = 0;
  if (p + 16 <= end && reinterpret_cast<uintptr_t>(b) % 16 == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(b);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = ws[i];
      bits |= ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) |
               ((x >> 21) & 8u))
              << (4 * i);
    }
  } else {
    for (int e = 0; e < 16 && p + e < end; ++e) bits |= (b[e] ? 1u : 0u) << e;
  }
  return bits;
}

struct Shared {
  uint16_t live[kLaneWindow];           // live lanes of the window, in
                                        // order, from its first lane
  alignas(16) uint8_t seen[kLaneWindow];  // the window's seen flags
  uint8_t probed[kMaxTile];             // a tile's items: bits found set
  int cell[kMaxTile];                   // a tile's items: twin cell or -1
  float val[kMaxTile];                  // and value
  float tree[kMaxTile];                 // the refund tree's leaves (zeroed)
  int qcol[kQueueCap];                  // queued cells: column
  long long qurl[kQueueCap];            // and URL, in column order
  int hash[kHashSlots];                 // URL -> lowest index in qcol
  int warp_sum[kMaxWarps];
};

// exclusive prefix of x over the block; *total gets the sum
__device__ __forceinline__ int block_scan(int x, int* total, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) sh.warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kMaxWarps ? sh.warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kMaxWarps) sh.warp_sum[lane] = w;
  }
  __syncthreads();
  *total = sh.warp_sum[kMaxWarps - 1];
  const int out = v - x + (warp > 0 ? sh.warp_sum[warp - 1] : 0);
  __syncthreads();  // warp_sum is free for the next scan
  return out;
}

__device__ __forceinline__ uint32_t url_hash(long long u) {
  return mix32(static_cast<uint32_t>(u) ^
                   static_cast<uint32_t>(static_cast<uint64_t>(u) >> 32),
               11u);
}

// the valid cells of columns [c0, c1) in column order into sh.qcol / qurl
// (at most kQueueCap are kept; returns how many there are), and their hash
__device__ int build_queue(const bool* qvalid, const int64_t* qurl, int c0,
                           int c1, Shared& sh) {
  int base = 0;
  for (int s0 = c0; s0 < c1; s0 += kThreads * 16) {
    const int p = s0 + threadIdx.x * 16;
    const uint32_t bits = p < c1 ? flags16(qvalid, p, c1) : 0u;
    int total;
    int at = base + block_scan(__popc(bits), &total, sh);
    for (uint32_t b = bits; b; b &= b - 1, ++at) {
      const int c = p + __ffs(b) - 1;
      if (at < kQueueCap) {
        sh.qcol[at] = c;
        sh.qurl[at] = qurl[c];
      }
    }
    base += total;
  }
  const int n = min(base, kQueueCap);
  for (int i = threadIdx.x; i < kHashSlots; i += kThreads) sh.hash[i] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long u = sh.qurl[i];
    uint32_t h = url_hash(u) & (kHashSlots - 1);
    while (true) {
      const int prev = atomicCAS(&sh.hash[h], -1, i);
      if (prev < 0) break;
      if (sh.qurl[prev] == u) {  // keep the lowest index: lowest column
        atomicMin(&sh.hash[h], i);
        break;
      }
      h = (h + 1) & (kHashSlots - 1);
    }
  }
  __syncthreads();
  return base;
}

// the lowest column of the built queue holding u, or -1
__device__ __forceinline__ int find_twin(long long u, const Shared& sh) {
  uint32_t h = url_hash(u) & (kHashSlots - 1);
  for (int i = sh.hash[h]; i >= 0; i = sh.hash[h]) {
    if (sh.qurl[i] == u) return sh.qcol[i];
    h = (h + 1) & (kHashSlots - 1);
  }
  return -1;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
dedup_deposit_kernel(uint8_t* filter, const int64_t* __restrict__ urls,
                     const bool* __restrict__ mask,
                     const float* __restrict__ val,
                     const int64_t* __restrict__ f_url,
                     const bool* __restrict__ f_valid, float* table,
                     bool* seen, float* refund, int M, int C, int k,
                     int bits_log2, int tile, int64_t ld_table) {
  __shared__ Shared sh;
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warps that apply deposits and sum the refund
  constexpr int dep_warp = 0, ref_warp = 1;
  // a row is 2^b bytes, or 2^b bits packed
  uint8_t* frow =
      filter + (row << (kPacked ? bits_log2 - 3 : bits_log2));
  const int64_t* urow = urls + row * M;
  const bool* mrow = mask + row * M;
  const float* vrow = val + row * M;
  const int64_t* qurl = f_url + row * C;
  const bool* qvalid = f_valid + row * C;
  float* trow = table + row * ld_table;
  const uint32_t bmask = (1u << bits_log2) - 1u;
  const uint32_t s1 = mix32(101u, 7u);
  const uint32_t s2 = mix32(202u, 7u);
  for (int i = tid; i < kMaxTile; i += kThreads) sh.tree[i] = 0.0f;
  float acc = 0.0f;     // the row's refund, kept by ref_warp's lane 0
  int queue_n = -1;     // the whole row's queue in shared memory: -1 not yet
  const int chunk = max(tile, kLaneWindow / tile * tile);
  for (int c0 = 0; c0 < M; c0 += chunk) {
    const int c1 = min(M, c0 + chunk);
    // (a) the chunk's live lanes, in order
    int n_live = 0;
    for (int s0 = c0; s0 < c1; s0 += kThreads * 16) {
      const int p = s0 + tid * 16;
      const uint32_t bits = p < c1 ? flags16(mrow, p, c1) : 0u;
      int total;
      int at = n_live + block_scan(__popc(bits), &total, sh);
      for (uint32_t b = bits; b; b &= b - 1)
        sh.live[at++] = static_cast<uint16_t>(p - c0 + __ffs(b) - 1);
      n_live += total;
    }
    for (int i = tid * 16; i < c1 - c0; i += kThreads * 16)
      *reinterpret_cast<uint4*>(&sh.seen[i]) = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // (b) the live lanes tile by tile
    for (int i0 = 0; i0 < n_live;) {
      const int t0 = (c0 + sh.live[i0]) / tile * tile;
      int lo = i0, hi = n_live;  // the first item past this tile
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (c0 + sh.live[mid] < t0 + tile) lo = mid + 1; else hi = mid;
      }
      const int n = lo - i0;
      bool any_seen = false;
      for (int i = tid; i < n; i += kThreads) {
        const int m = c0 + sh.live[i0 + i];
        const uint32_t u32 = static_cast<uint32_t>(urow[m]);
        const uint32_t h1 = mix32(u32 + s1, 0u);
        const uint32_t h2 = mix32(u32 + s2, 0u) | 1u;
        // all k loads issued at once; the bits found set are kept (k <= 8)
        // so that the insert need not read them again
        uint32_t found = 0;
        bool s = true;
#pragma unroll 4
        for (int j = 0; j < k; ++j) {
          const bool bit = test_bit<kPacked>(
              frow, (h1 + static_cast<uint32_t>(j) * h2) & bmask);
          s &= bit;
          found |= static_cast<uint32_t>(bit) << (j & 7);
        }
        sh.probed[i] = static_cast<uint8_t>(found);
        sh.seen[m - c0] = s;
        any_seen |= s;
      }
      // every probe of the tile reads the filter before any insert
      any_seen = __syncthreads_or(any_seen);
      for (int i = tid; i < n; i += kThreads) {
        const int m = c0 + sh.live[i0 + i];
        const uint32_t u32 = static_cast<uint32_t>(urow[m]);
        const uint32_t h1 = mix32(u32 + s1, 0u);
        const uint32_t h2 = mix32(u32 + s2, 0u) | 1u;
        const uint32_t found = sh.probed[i];
        for (int j = 0; j < k; ++j) {
          const uint32_t pos = (h1 + static_cast<uint32_t>(j) * h2) & bmask;
          if (k > 8) set_bit<kPacked>(frow, pos);
          else if (!((found >> j) & 1u)) set_new_bit<kPacked>(frow, pos);
        }
      }
      if (any_seen) {
        // (c) the twins, from the row's queue in shared memory
        for (int i = tid; i < n; i += kThreads) sh.cell[i] = -1;
        if (queue_n < 0) queue_n = build_queue(qvalid, qurl, 0, C, sh);
        const bool whole = queue_n <= kQueueCap;
        for (int q0 = 0; q0 < C; q0 += kQueueCap) {
          if (!whole)
            build_queue(qvalid, qurl, q0, min(C, q0 + kQueueCap), sh);
          for (int i = tid; i < n; i += kThreads) {
            const int m = c0 + sh.live[i0 + i];
            if (sh.seen[m - c0] && sh.cell[i] < 0)
              sh.cell[i] = find_twin(urow[m], sh);
          }
          if (whole) break;
          __syncthreads();  // the next chunk overwrites the queue
        }
        for (int i = tid; i < n; i += kThreads) {
          const int m = c0 + sh.live[i0 + i];
          const float v = sh.seen[m - c0] ? vrow[m] : 0.0f;
          sh.val[i] = v;
          if (sh.seen[m - c0] && sh.cell[i] < 0) sh.tree[m - t0] = v;
        }
      }
      // this tile's inserts before the next tile's probes; cell, val and
      // tree published
      __syncthreads();
      if (any_seen && warp == dep_warp) {
        // (d) deposits in item order: equal cells of 32 items by match,
        // the lowest lane adds them one by one
        for (int b0 = 0; b0 < n; b0 += 32) {
          const int i = b0 + lane;
          const int c = i < n ? sh.cell[i] : -1;
          const unsigned same = __match_any_sync(0xffffffffu, c);
          if (c >= 0 && lane == __ffs(same) - 1) {
            float x = trow[c];
            for (unsigned s = same; s; s &= s - 1)
              x = x + sh.val[b0 + __ffs(s) - 1];
            trow[c] = x;
          }
          __syncwarp();
        }
      }
      if (any_seen && warp == ref_warp) {
        // (e) tree_sum over the tile's power-of-two width
        const int width = min(tile, M - t0);
        int P = 1;
        while (P < width) P <<= 1;
        for (int h = P >> 1; h >= 32; h >>= 1)
          for (int j = lane; j < h; j += 32)
            sh.tree[j] = sh.tree[j] + sh.tree[j + h];
        float x = lane < P ? sh.tree[lane] : 0.0f;
        for (int h = min(P, 32) >> 1; h >= 1; h >>= 1) {
          const float y = __shfl_down_sync(0xffffffffu, x, h);
          if (lane < h) x = x + y;
        }
        if (lane == 0) acc = acc + x;
        for (int j = lane; j < P; j += 32) sh.tree[j] = 0.0f;
      }
      i0 = lo;
    }
    __syncthreads();  // every seen flag of the chunk is in shared memory
    bool* srow = seen + row * M;
    for (int i = tid * 16; i < c1 - c0; i += kThreads * 16) {
      const int64_t p = c0 + i;
      uint8_t* dst = reinterpret_cast<uint8_t*>(srow + p);
      if (p + 16 <= c1 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&sh.seen[i]);
      } else {
        for (int e = 0; e < 16 && p + e < c1; ++e) dst[e] = sh.seen[i + e];
      }
    }
    __syncthreads();  // the next chunk overwrites live and seen
  }
  if (warp == ref_warp && lane == 0) refund[row] = acc;
}

template <bool kPacked>
int launch(void* filter, const void* urls, const void* mask, const void* val,
           const void* f_url, const void* f_valid, void* table, void* seen,
           void* refund, int R, int M, int C, int k, int bits_log2, int tile,
           int ld_table, void* stream) {
  if (R > 0 && M > 0) {
    if (tile < 1 || tile > kMaxTile) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    dedup_deposit_kernel<kPacked><<<R, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(filter), static_cast<const int64_t*>(urls),
        static_cast<const bool*>(mask), static_cast<const float*>(val),
        static_cast<const int64_t*>(f_url), static_cast<const bool*>(f_valid),
        static_cast<float*>(table), static_cast<bool*>(seen),
        static_cast<float*>(refund), M, C, k, bits_log2, tile,
        static_cast<int64_t>(ld_table));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dedup_deposit_launch(void* bits, const void* urls,
                                    const void* mask, const void* val,
                                    const void* f_url, const void* f_valid,
                                    void* table, void* seen, void* refund,
                                    int R, int M, int C, int k,
                                    int bits_log2, int tile, int ld_table,
                                    void* stream) {
  return launch<false>(bits, urls, mask, val, f_url, f_valid, table, seen,
                       refund, R, M, C, k, bits_log2, tile, ld_table, stream);
}

// words: (R, 2^b / 32) 32-bit words; bits_log2 = b (5 <= b <= 31)
extern "C" int dedup_deposit_packed_launch(
    void* words, const void* urls, const void* mask, const void* val,
    const void* f_url, const void* f_valid, void* table, void* seen,
    void* refund, int R, int M, int C, int k, int bits_log2, int tile,
    int ld_table, void* stream) {
  return launch<true>(words, urls, mask, val, f_url, f_valid, table, seen,
                      refund, R, M, C, k, bits_log2, tile, ld_table, stream);
}

extern "C" const char* dedup_deposit_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

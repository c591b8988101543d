// bloom — the dispatcher's Bloom-filter probe and insert, written by hand
// for Hopper (sm_90a), on byte-per-bit rows (bloom_launch) and on packed
// rows of 32-bit words (bloom_packed_launch), both from one template.
//
// Replaces the TPU kernels repro/kernels/bloom/bloom.py:61
// (bloom_probe_insert, body _kernel at :43) and bloom.py:137
// (bloom_probe_insert_packed, body _packed_kernel at :103): per filter row,
// URL tiles of `tile` are walked in order; each URL gets k double-hash
// positions; `seen` is "all k bits already set" read after the earlier
// tiles inserted (within a tile, before the tile), ANDed with the mask; then
// the tile's masked URLs set their bits. A byte-per-bit row holds bit p in
// byte p; a packed row holds it in bit p & 31 of word p >> 5.
//
// What bounds it on this card: bytes, in scattered accesses. A 16 MiB
// filter row (2 MiB packed) does not fit in shared memory (the TPU streamed
// the row into VMEM), so every probe is a read of one byte or word at a
// hashed address of device memory and every insert a write. The bytes the
// function must move are the mask and the `seen` flag of every lane (1 B
// each), the live URLs (8 B each, read in 32-byte sectors) and k bytes (k
// 4-byte words packed) per live URL, plus the bytes (words) it newly sets.
// On the main path a dispatch batch is (512, 4096) lanes with about 2,000
// live, packed at the front of each row: about 4.3 MB, some 1.3 us at 3.35
// TB/s, for either layout. With ~4 live lanes a row and every row's block
// resident at once, what the time is made of is a row's chain of dependent
// round trips to device memory and its barriers, not the bytes.
//
// What the design does about it: one block of 256 threads per row, in
// these steps. (1) The row's mask is read as 16-byte vectors and its live
// lanes compacted, in order, into shared memory by a block scan, a window
// of 4,096 lanes (whole tiles) at a time; the window's `seen` is zeroed in
// shared memory. A row with no live lane costs this one pass, and empty
// tiles cost nothing. (2) Each tile that holds a live lane is walked: its
// items are probed in one round trip (every URL loaded and all k probe
// loads issued at once, the hashes and the bits found set kept in the
// thread's registers: a tile of at most 1,024 items is at most 4 a thread),
// a barrier, then (3) only the bits found clear are written, with no second
// read and no second URL load: a byte store, or an atomicOr on the word (OR
// is commutative and idempotent, so the words come out as the serial walk
// leaves them); a barrier follows, so the next tile probes after these
// inserts. (4) `seen` is written back from shared memory as 16-byte vectors
// where the span is whole and aligned. The crawl's rows hold their few live
// lanes at the front, in one tile, so a dispatch row costs one pass over its
// mask and one walked tile. Several tiles are not probed in one round
// trip: front-packed lanes fill a tile before the next, so at k 4 a
// shared table of 1,024 positions would hold one tile of 256 (PERF.md §6).
// The filter is updated IN PLACE: at the full config the filters are 512 x
// 16 MiB = 8 GiB (1 GiB packed), and a functional copy per dispatch would
// move the whole filter twice to change a few hundred kilobytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;        // a row's block
constexpr int kLaneWindow = 4096;    // lanes compacted at a time
constexpr int kMaxTile = 1024;
constexpr int kItems = kMaxTile / kThreads;  // a tile's items a thread holds
constexpr int kMaxWarps = kThreads / 32;

// repro/core/webgraph.py _mix: murmur3-style finalizer on uint32
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t salt) {
  x ^= salt * 0x9E3779B9u + 0x85EBCA6Bu;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// One filter bit at position `pos` of a row: a byte (0 or 1), or bit
// pos & 31 of the row's word pos >> 5.
template <bool kPacked>
__device__ __forceinline__ bool test_bit(const uint8_t* frow, uint32_t pos) {
  if constexpr (kPacked) {
    return (reinterpret_cast<const uint32_t*>(frow)[pos >> 5] >> (pos & 31)) &
           1u;
  } else {
    return frow[pos] == 1;
  }
}

// Set a bit with no read first (a store, or an atomicOr packed, that no
// one waits for): another URL may set it too, which leaves it set either
// way. Called for the bits the probe found clear (for every bit past the
// 32nd, where a register cannot hold what the probe found).
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
  uint16_t live[kLaneWindow];             // live lanes of the window, in
                                          // order, from its first lane
  alignas(16) uint8_t seen[kLaneWindow];  // the window's seen flags
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

// the first index in [lo, hi) whose live lane is at or past `lane`, or hi
__device__ __forceinline__ int first_at(const uint16_t* live, int lo, int hi,
                                        int lane) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (live[mid] < lane) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
bloom_kernel(uint8_t* filter, const int64_t* __restrict__ urls,
             const bool* __restrict__ mask, bool* __restrict__ seen, int M,
             int k, int bits_log2, int tile) {
  __shared__ Shared sh;
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  // a row is 2^b bytes, or 2^b bits packed
  uint8_t* frow = filter + (row << (kPacked ? bits_log2 - 3 : bits_log2));
  const int64_t* urow = urls + row * M;
  const bool* mrow = mask + row * M;
  bool* srow = seen + row * M;
  const uint32_t bmask = (1u << bits_log2) - 1u;
  // hash2(u, b) = mix(u + mix(b, 7), 0) for b = 101 and 202
  // (dedup._bit_indices)
  const uint32_t s1 = mix32(101u, 7u);
  const uint32_t s2 = mix32(202u, 7u);
  const int chunk = kLaneWindow / tile * tile;  // a window of whole tiles
  for (int c0 = 0; c0 < M; c0 += chunk) {
    const int c1 = min(M, c0 + chunk);
    // (1) the window's live lanes, in order; its seen zeroed (each thread
    // zeroes the 16 lanes whose mask it read, and writes them back in (4))
    int n_live = 0;
    for (int s0 = c0; s0 < c1; s0 += kThreads * 16) {
      const int p = s0 + tid * 16;
      uint32_t bits = 0;
      if (p < c1) {
        bits = flags16(mrow, p, c1);
        *reinterpret_cast<uint4*>(&sh.seen[p - c0]) = make_uint4(0, 0, 0, 0);
      }
      int total;
      int at = n_live + block_scan(__popc(bits), &total, sh);
      for (uint32_t b = bits; b; b &= b - 1)
        sh.live[at++] = static_cast<uint16_t>(p - c0 + __ffs(b) - 1);
      n_live += total;
    }
    __syncthreads();  // live published
    // the tiles that hold a live lane, in order: [g0, g1) is one tile's
    for (int g0 = 0; g0 < n_live;) {
      const int t0 = sh.live[g0] / tile;
      const int g1 = first_at(sh.live, g0, min(n_live, g0 + tile),
                              (t0 + 1) * tile);
      const int n = g1 - g0;
      // (2) probe: all k loads at once; the hashes and the bits found set
      // stay in registers for the insert
      uint32_t h1[kItems], h2[kItems], found[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int i = tid + r * kThreads;
        if (i < n) {
          const int lane = sh.live[g0 + i];
          const uint32_t u32 = static_cast<uint32_t>(urow[c0 + lane]);
          h1[r] = mix32(u32 + s1, 0u);
          h2[r] = mix32(u32 + s2, 0u) | 1u;
          uint32_t f = 0;
          bool s = true;
#pragma unroll 4
          for (int j = 0; j < k; ++j) {
            const bool bit = test_bit<kPacked>(
                frow, (h1[r] + static_cast<uint32_t>(j) * h2[r]) & bmask);
            s &= bit;
            if (j < 32) f |= static_cast<uint32_t>(bit) << j;
          }
          found[r] = f;
          sh.seen[lane] = s;
        }
      }
      __syncthreads();  // every probe of the tile reads the filter first
      // (3) insert only the bits found clear
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        if (tid + r * kThreads < n) {
          for (int j = 0; j < k; ++j) {
            if (j >= 32 || !((found[r] >> j) & 1u))
              set_new_bit<kPacked>(
                  frow, (h1[r] + static_cast<uint32_t>(j) * h2[r]) & bmask);
          }
        }
      }
      __syncthreads();  // this tile's inserts before the next probes
      g0 = g1;
    }
    // (4) seen back as 16-byte vectors. No barrier is needed after it: a
    // thread zeroes, next window, the very lanes it writes here, and live
    // is rewritten only after the next block scan's barriers
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
  }
}

template <bool kPacked>
int launch(void* filter, const void* urls, const void* mask, void* seen,
           int R, int M, int k, int bits_log2, int tile, void* stream) {
  if (R > 0 && M > 0) {
    if (tile < 1 || tile > kMaxTile || k < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bloom_kernel<kPacked><<<R, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(filter), static_cast<const int64_t*>(urls),
        static_cast<const bool*>(mask), static_cast<bool*>(seen), M, k,
        bits_log2, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bloom_launch(void* bits, const void* urls, const void* mask,
                            void* seen, int R, int M, int k, int bits_log2,
                            int tile, void* stream) {
  return launch<false>(bits, urls, mask, seen, R, M, k, bits_log2, tile,
                       stream);
}

// words: (R, 2^b / 32) 32-bit words; bits_log2 = b (5 <= b <= 31)
extern "C" int bloom_packed_launch(void* words, const void* urls,
                                   const void* mask, void* seen, int R, int M,
                                   int k, int bits_log2, int tile,
                                   void* stream) {
  return launch<true>(words, urls, mask, seen, R, M, k, bits_log2, tile,
                      stream);
}

extern "C" const char* bloom_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

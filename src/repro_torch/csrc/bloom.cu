// bloom — the dispatcher's Bloom-filter probe and insert, written by hand
// for Hopper (sm_90a), on byte-per-bit rows (bloom_launch) and on packed
// rows of 32-bit words (bloom_packed_launch).
//
// Replaces the TPU kernels repro/kernels/bloom/bloom.py:61
// (bloom_probe_insert, body _kernel at :43) and bloom.py:137
// (bloom_probe_insert_packed, body _packed_kernel at :103): per filter row,
// URL tiles of 256 are walked in order; each URL gets k double-hash
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
// TB/s, for either layout. Each scattered access costs a 32-byte sector in
// practice.
//
// What the design does about it: one block per row, one thread per URL of
// the tile, so a tile's probes are in flight together, and a masked-out URL
// (most of the dispatch batch) reads neither its URL nor any filter byte,
// nor does a live URL read past its first unset bit; the tiles of a row run
// in order inside the block, with __syncthreads() between the probes and
// the inserts of a tile and between tiles, which reproduces the TPU
// kernel's order exactly. The ragged last tile is masked here rather than
// padded by a copy. The update is IN PLACE on the filter: at the full
// config the filters are 512 x 16 MiB = 8 GiB (1 GiB packed), and a
// functional copy per dispatch would move the whole filter twice to change
// a few hundred kilobytes. An insert writes only a bit that is still 0. In
// a packed row two URLs of one tile may set different bits of one word, so
// the insert is an atomicOr: OR is commutative and idempotent, so the words
// come out as the serial walk leaves them (the TPU kernel got the same by
// 32 bit-plane scatter passes).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

template <bool kPacked>
__global__ void bloom_kernel(uint8_t* filter, const int64_t* __restrict__ urls,
                             const bool* __restrict__ mask, bool* seen, int M,
                             int k, int bits_log2, int tile) {
  const size_t row = blockIdx.x;
  // a row is 2^b bytes, or 2^b bits packed
  uint8_t* frow = filter + (row << (kPacked ? bits_log2 - 3 : bits_log2));
  const uint32_t bmask = (1u << bits_log2) - 1u;
  // hash2(u, b) = mix(u + mix(b, 7), 0) for b = 101 and 202 (dedup._bit_indices)
  const uint32_t c1 = mix32(101u, 7u);
  const uint32_t c2 = mix32(202u, 7u);
  for (int t0 = 0; t0 < M; t0 += tile) {
    const int m = t0 + static_cast<int>(threadIdx.x);
    const bool active = static_cast<int>(threadIdx.x) < tile && m < M;
    bool ins = false;
    uint32_t h1 = 0, h2 = 0;
    if (active) {
      const size_t o = row * M + m;
      ins = mask[o];
      bool all = false;  // a masked-out URL is never seen: no URL, no probes
      if (ins) {
        const uint32_t u = static_cast<uint32_t>(urls[o]);
        h1 = mix32(u + c1, 0u);
        h2 = mix32(u + c2, 0u) | 1u;
        all = true;
        for (int i = 0; all && i < k; ++i) {
          all = test_bit<kPacked>(frow,
                                  (h1 + static_cast<uint32_t>(i) * h2) & bmask);
        }
      }
      seen[o] = all;
    }
    __syncthreads();  // every probe of the tile reads the filter before it
    if (ins) {
      for (int i = 0; i < k; ++i) {
        set_bit<kPacked>(frow, (h1 + static_cast<uint32_t>(i) * h2) & bmask);
      }
    }
    __syncthreads();  // the next tile probes after this tile's inserts
  }
}

template <bool kPacked>
int launch(void* filter, const void* urls, const void* mask, void* seen,
           int R, int M, int k, int bits_log2, int tile, void* stream) {
  if (R > 0 && M > 0) {
    const int threads = (tile + 31) / 32 * 32;
    bloom_kernel<kPacked><<<R, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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

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
// tiles inserted and before this tile does, ANDed with the mask; (2) each seen
// URL is matched against the URLs still queued in its row (f_url where
// f_valid), the first such cell wins; (3) its value is added to that cell
// of the url lane `table`, in item order; (4) the values of seen URLs with
// no queued twin are summed by a halving tree over the tile and added to
// the row's refund (the same tree as kernels/rowsum.py's tree_sum).
//
// What bounds it on this card: bytes, in scattered accesses, and the twin
// scan. A 16 MiB filter row (2 MiB packed) fits no shared memory, so every
// probe is a byte or word at a hashed address of device memory (as in
// bloom.cu). The function must read each lane's mask and write its `seen`
// (1 B each), read the live URLs (8 B) and values (4 B), k filter bytes (k
// 4-byte words packed) per live URL, the bytes (words) it newly sets, and
// for each seen URL its row's queue up to its twin.
//
// What the design does about it: one block per row, one thread per URL of
// the tile, tiles in order inside the block with barriers between the
// probes and the inserts and between tiles, as in bloom.cu. A masked-out
// URL reads nothing. A packed insert is an atomicOr on its word, so two
// URLs of a tile that set different bits of one word both keep theirs and
// the words come out as the serial walk leaves them (bloom.cu). A seen URL
// scans its row's queue from column 0 and stops at its first twin; the
// threads of a warp read the same cell at once, so the scan is served by
// broadcast from the cache. The deposits of
// a tile are applied by one thread in item order, so a cell hit twice adds
// in the same order as the plain version, and only in a tile that has a
// hit. No (R, M, C) comparison is formed. The filter and the lane are
// updated in place; the lane may be a strided view (order_state[:, 2:]).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

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

template <bool kPacked>
__global__ void dedup_deposit_kernel(
    uint8_t* filter, const int64_t* __restrict__ urls,
    const bool* __restrict__ mask, const float* __restrict__ val,
    const int64_t* __restrict__ f_url, const bool* __restrict__ f_valid,
    float* table, bool* seen, float* refund, int M, int C, int k,
    int bits_log2, int tile, int64_t ld_table) {
  __shared__ float s_red[kMaxThreads];
  __shared__ int s_cell[kMaxThreads];
  __shared__ float s_val[kMaxThreads];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  // a row is 2^b bytes, or 2^b bits packed
  uint8_t* frow = filter + (row << (kPacked ? bits_log2 - 3 : bits_log2));
  const int64_t* qurl = f_url + row * C;
  const bool* qvalid = f_valid + row * C;
  float* trow = table + row * ld_table;
  const uint32_t bmask = (1u << bits_log2) - 1u;
  const uint32_t c1 = mix32(101u, 7u);
  const uint32_t c2 = mix32(202u, 7u);
  float acc = 0.0f;  // the row's refund, kept by thread 0
  for (int t0 = 0; t0 < M; t0 += tile) {
    const int m = t0 + tid;
    const bool active = tid < tile && m < M;
    const size_t o = row * M + m;
    bool ins = false, s = false;
    uint32_t h1 = 0, h2 = 0;
    int64_t u = 0;
    if (active) {
      ins = mask[o];
      if (ins) {
        u = urls[o];
        const uint32_t u32 = static_cast<uint32_t>(u);
        h1 = mix32(u32 + c1, 0u);
        h2 = mix32(u32 + c2, 0u) | 1u;
        s = true;
        for (int i = 0; s && i < k; ++i) {
          s = test_bit<kPacked>(frow,
                                (h1 + static_cast<uint32_t>(i) * h2) & bmask);
        }
      }
      seen[o] = s;
    }
    __syncthreads();  // every probe of the tile reads the filter before it
    if (ins) {
      for (int i = 0; i < k; ++i) {
        set_bit<kPacked>(frow, (h1 + static_cast<uint32_t>(i) * h2) & bmask);
      }
    }
    int cell = -1;
    float v = 0.0f;
    if (s) {
      v = val[o];
      for (int c = 0; c < C; ++c) {
        if (qvalid[c] && qurl[c] == u) {
          cell = c;
          break;
        }
      }
    }
    s_cell[tid] = cell;
    s_val[tid] = v;
    s_red[tid] = (s && cell < 0) ? v : 0.0f;
    // the barriers also put this tile's inserts before the next tile's
    // probes
    const bool any_hit = __syncthreads_or(cell >= 0);
    const bool any_refund = __syncthreads_or(s && cell < 0);
    if (any_refund) {
      for (int h = blockDim.x / 2; h > 0; h >>= 1) {
        if (tid < h) s_red[tid] = s_red[tid] + s_red[tid + h];
        __syncthreads();
      }
    }
    if (tid == 0) {
      if (any_refund) acc = acc + s_red[0];
      if (any_hit) {
        const int n = min(tile, M - t0);
        for (int i = 0; i < n; ++i) {
          if (s_cell[i] >= 0) trow[s_cell[i]] = trow[s_cell[i]] + s_val[i];
        }
      }
    }
    __syncthreads();  // the next tile overwrites the shared arrays
  }
  if (tid == 0) refund[row] = acc;
}

template <bool kPacked>
int launch(void* filter, const void* urls, const void* mask, const void* val,
           const void* f_url, const void* f_valid, void* table, void* seen,
           void* refund, int R, int M, int C, int k, int bits_log2, int tile,
           int ld_table, void* stream) {
  if (R > 0 && M > 0) {
    if (tile < 1 || tile > kMaxThreads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int threads = 32;  // a power of two for the refund tree
    while (threads < tile) threads *= 2;
    dedup_deposit_kernel<kPacked><<<R, threads, 0,
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

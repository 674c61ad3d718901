// Stable LSD radix sort of 64-bit keys carrying an int32 index, for Hopper.
//
// Replaces allpathslg_tpu/ops/pallas/sort_pallas.py::sort_two_words, and
// stands wherever the JAX slice sorts k-mer keys with lax.sort
// (kmer/count.py count_sorted, ops/sort.py sort_by_words, ec/spectrum_ec.py
// strong_table, ops/join.py build_hashed, ec/precorrect.py). A key of two
// uint32 words (w0, w1) is the uint64 (w0 << 32) | w1; a one-word key is w0.
// The all-ones sentinel is the largest key and sorts last with no special
// case. Keys of three or more words are sorted by stable passes of this
// sort, least significant word group first (ops/sort.py).
//
// Bound: device-memory bytes. A pass reads the keys once to count digits,
// then reads 8 B of key + 4 B of index and writes both again: 32 B per key
// per pass, against a few integer operations.
// What the design does about that bound:
//   * 8-bit digits, so 64 bits take at most 8 passes;
//   * one OR-reduction over (key ^ key[0]) first finds the digits in which
//     all keys agree, and those passes are skipped: K=24 keys leave the low
//     16 bits of w1 zero (6 passes), one-word keys the high 32 bits (<= 4);
//   * a warp reads 32 consecutive keys (coalesced); the scatter first
//     places its tile in shared memory in digit order, so that consecutive
//     threads store each digit's run of the tile to consecutive addresses.
// A one-sweep decoupled look-back in place of the separate count pass is
// left for later: this is the simple design that is right first.
//
// Built by allpathslg_tpu_torch/ops/cuda/sort_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the extern "C" functions at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;    // 256 digit values
constexpr int kThreads = 256;              // one digit per thread in scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // keys per thread
constexpr int kTile = kThreads * kItems;   // 4096 keys per block
constexpr int kWarpTile = kTile / kWarps;  // 512 keys per warp: 16 chunks
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoDigit = kRadix;      // lanes past the end of the keys

static_assert(kThreads == kRadix, "scans give one digit to each thread");
static_assert(kWarpTile == 32 * kItems, "a warp walks its tile in chunks");

__device__ __forceinline__ unsigned digit_of(uint64_t key, int shift) {
  return static_cast<unsigned>((key >> shift) & (kRadix - 1));
}

// Inclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it (it synchronises twice).
__device__ uint32_t block_inclusive_scan(uint32_t v, uint32_t* warp_sums,
                                         uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = warp_sums[w];
    if (w < warp) before += s;
    sum += s;
  }
  __syncthreads();  // warp_sums is free for the next call
  *total = sum;
  return before + x;
}

// out |= OR over i of (keys[i] ^ keys[0]): the bits in which keys differ.
__global__ void differing_bits_kernel(const uint64_t* __restrict__ keys,
                                      int64_t n, unsigned long long* out) {
  const uint64_t first = keys[0];
  uint64_t acc = 0;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    acc |= keys[i] ^ first;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc |= __shfl_xor_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0 && acc != 0) {
    atomicOr(out, static_cast<unsigned long long>(acc));
  }
}

// counts[d * nblk + b] = number of keys of tile b whose digit is d. Each
// warp counts into its own shared histogram with plain shared atomics
// (measured faster on H100 than grouping lanes with __match_any_sync).
__global__ void tile_histogram_kernel(const uint64_t* __restrict__ keys,
                                      int64_t n, int shift,
                                      uint32_t* __restrict__ counts,
                                      int nblk) {
  __shared__ uint32_t hist[kWarps][kRadix];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) hist[w][threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + warp * kWarpTile + lane;
#pragma unroll 4
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = base + c * 32;
    if (i < n) atomicAdd(&hist[warp][digit_of(keys[i], shift)], 1u);
  }
  __syncthreads();
  uint32_t sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += hist[w][threadIdx.x];
  counts[static_cast<int64_t>(threadIdx.x) * nblk + blockIdx.x] = sum;
}

// Block d: exclusive prefix over tiles of digit d's counts, in place, and
// totals[d] = the number of keys with digit d.
__global__ void scan_tiles_kernel(uint32_t* __restrict__ counts, int nblk,
                                  uint32_t* __restrict__ totals) {
  __shared__ uint32_t warp_sums[kWarps];
  uint32_t* row = counts + static_cast<int64_t>(blockIdx.x) * nblk;
  uint32_t carry = 0;
  for (int start = 0; start < nblk; start += kThreads) {
    const int i = start + threadIdx.x;
    const uint32_t v = i < nblk ? row[i] : 0;
    uint32_t chunk_total;
    const uint32_t incl = block_inclusive_scan(v, warp_sums, &chunk_total);
    if (i < nblk) row[i] = carry + incl - v;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Stable scatter of one tile by the digit at `shift`. A key's place is
//   bucket start of its digit (scan of totals)
// + keys of that digit in earlier tiles (scanned counts)
// + keys of that digit earlier in this tile.
// The last term is ranked in input order: warp w holds keys
// [w * kWarpTile, (w + 1) * kWarpTile) of the tile and walks them in chunks
// of 32; __match_any_sync groups the lanes of a chunk by digit, a lane's
// rank among its peers is the count of lower lanes, and per-warp counters
// carry the rank across chunks. A prefix over warps then orders warps.
// Three blocks per SM (80 registers a thread) measured faster on H100 than
// the compiler's own choice of two.
__global__ void __launch_bounds__(kThreads, 3)
    scatter_kernel(const uint64_t* __restrict__ keys_in,
                               const int32_t* __restrict__ idx_in,
                               uint64_t* __restrict__ keys_out,
                               int32_t* __restrict__ idx_out, int64_t n,
                               int shift, const uint32_t* __restrict__ counts,
                               int nblk, const uint32_t* __restrict__ totals) {
  __shared__ uint64_t stage_keys[kTile];        // 32 KB
  __shared__ uint8_t stage_digit[kTile];        // 4 KB
  __shared__ uint32_t warp_count[kWarps][kRadix];
  __shared__ uint32_t tile_base[kRadix];
  __shared__ uint32_t digit_start[kRadix];
  __shared__ uint32_t warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][tid] = 0;
  const uint32_t t = totals[tid];
  uint32_t all_keys;
  const uint32_t bucket_start =
      block_inclusive_scan(t, warp_sums, &all_keys) - t;
  tile_base[tid] =
      bucket_start + counts[static_cast<int64_t>(tid) * nblk + blockIdx.x];
  __syncthreads();

  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + warp * kWarpTile + lane;
  const unsigned lower_lanes = (1u << lane) - 1u;
  uint64_t key[kItems];
  uint32_t rank[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = base + c * 32;
    key[c] = i < n ? keys_in[i] : 0;
    const unsigned d = i < n ? digit_of(key[c], shift) : kNoDigit;
    const unsigned peers = __match_any_sync(kFull, d);
    uint32_t before = 0;
    if (d != kNoDigit) before = warp_count[warp][d];
    __syncwarp();
    if (d != kNoDigit && lane == __ffs(peers) - 1) {
      warp_count[warp][d] = before + __popc(peers);
    }
    __syncwarp();
    rank[c] = before + __popc(peers & lower_lanes);
  }
  __syncthreads();
  // exclusive prefix over warps of each digit's count (thread tid: digit tid)
  uint32_t run = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_count[w][tid];
    warp_count[w][tid] = run;
    run += c;
  }
  // where each digit's keys start in the tile sorted by this digit
  uint32_t tile_n;
  digit_start[tid] = block_inclusive_scan(run, warp_sums, &tile_n) - run;
  __syncthreads();

  // Stage the tile in shared memory in digit order, then write it out by
  // consecutive threads: a digit's keys of this tile are one run of
  // consecutive addresses in the output, so the stores coalesce. The index
  // follows through the same buffer once the keys are out.
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (base + c * 32 < n) {
      const unsigned d = digit_of(key[c], shift);
      rank[c] += digit_start[d] + warp_count[warp][d];  // place in the tile
      stage_keys[rank[c]] = key[c];
    }
  }
  __syncthreads();
  for (uint32_t j = tid; j < tile_n; j += kThreads) {
    const uint64_t k = stage_keys[j];
    const unsigned d = digit_of(k, shift);
    stage_digit[j] = static_cast<uint8_t>(d);
    keys_out[tile_base[d] + j - digit_start[d]] = k;
  }
  __syncthreads();
  int32_t* stage_idx = reinterpret_cast<int32_t*>(stage_keys);
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = base + c * 32;
    if (i < n) {
      stage_idx[rank[c]] =
          idx_in != nullptr ? idx_in[i] : static_cast<int32_t>(i);
    }
  }
  __syncthreads();
  for (uint32_t j = tid; j < tile_n; j += kThreads) {
    const unsigned d = stage_digit[j];
    idx_out[tile_base[d] + j - digit_start[d]] = stage_idx[j];
  }
}

__global__ void iota_kernel(int32_t* __restrict__ idx, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    idx[i] = static_cast<int32_t>(i);
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1056 ? blocks : 1056);  // 8 per SM
}

}  // namespace

extern "C" {

// Keys per tile: the wrapper sizes the counts scratch as 256 * tiles.
int radix_sort_tile_keys() { return kTile; }

const char* radix_sort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sorts keys_in[0..n) (left untouched) ascending as unsigned integers of
// key_bits bits (32 or 64), stably. The sorted keys and the permutation
// (sorted position -> input position) land in (keys_a, idx_a) when
// *result_in_b is 0 and in (keys_b, idx_b) when it is 1. Scratch: counts
// holds 256 * ceil(n / tile) words, totals 256, diff one 64-bit word.
// Runs on `stream`; synchronises it once, to read which digits differ.
// Returns 0 or the CUDA error of the first call that failed.
int radix_sort_u64(const uint64_t* keys_in, uint64_t* keys_a, int32_t* idx_a,
                   uint64_t* keys_b, int32_t* idx_b, uint32_t* counts,
                   uint32_t* totals, unsigned long long* diff, int64_t n,
                   int key_bits, void* stream_handle, int* result_in_b) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  *result_in_b = 0;
  if (n <= 0) return 0;
  if (n >= (static_cast<int64_t>(1) << 31)) return cudaErrorInvalidValue;
  if (key_bits <= 0 || key_bits > 64) return cudaErrorInvalidValue;
  const int nblk = static_cast<int>((n + kTile - 1) / kTile);
  cudaError_t err;

  if ((err = cudaMemsetAsync(diff, 0, sizeof(*diff), stream)) != cudaSuccess)
    return err;
  differing_bits_kernel<<<grid_for(n), kThreads, 0, stream>>>(keys_in, n, diff);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  unsigned long long mask = 0;
  if ((err = cudaMemcpyAsync(&mask, diff, sizeof(mask), cudaMemcpyDeviceToHost,
                             stream)) != cudaSuccess)
    return err;
  if ((err = cudaStreamSynchronize(stream)) != cudaSuccess) return err;
  if (key_bits < 64) mask &= (1ull << key_bits) - 1ull;

  const uint64_t* src_k = keys_in;
  const int32_t* src_i = nullptr;  // first pass: index = input position
  int into_b = 0;
  bool sorted_any = false;
  for (int shift = 0; shift < key_bits; shift += kRadixBits) {
    if (((mask >> shift) & (kRadix - 1)) == 0) continue;  // all keys agree
    uint64_t* dst_k = into_b ? keys_b : keys_a;
    int32_t* dst_i = into_b ? idx_b : idx_a;
    tile_histogram_kernel<<<nblk, kThreads, 0, stream>>>(src_k, n, shift,
                                                         counts, nblk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_tiles_kernel<<<kRadix, kThreads, 0, stream>>>(counts, nblk, totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scatter_kernel<<<nblk, kThreads, 0, stream>>>(src_k, src_i, dst_k, dst_i,
                                                  n, shift, counts, nblk,
                                                  totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src_k = dst_k;
    src_i = dst_i;
    into_b ^= 1;
    sorted_any = true;
  }
  if (!sorted_any) {  // every key is equal: the input order is sorted
    if ((err = cudaMemcpyAsync(keys_a, keys_in, n * sizeof(uint64_t),
                               cudaMemcpyDeviceToDevice, stream)) != cudaSuccess)
      return err;
    iota_kernel<<<grid_for(n), kThreads, 0, stream>>>(idx_a, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return 0;
  }
  *result_in_b = into_b ? 0 : 1;  // the last pass wrote the other buffer
  return 0;
}

}  // extern "C"

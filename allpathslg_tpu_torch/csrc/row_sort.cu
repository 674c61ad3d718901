// Stable LSD radix sort of every row of a [rows, row_len] matrix of 64-bit
// keys, each row on its own, with an int32 index within the row, for Hopper.
//
// Replaces the batched row sorts of allpathslg_tpu/ops/bucket_count.py
// (group_keys: lax.sort(dimension=1) of the tiles, :73, and of the bucket
// slabs, :117): an XLA sort, not a Pallas kernel, which the reference keeps
// on-chip a row at a time. A key of two uint32 words (w0, w1) is the uint64
// (w0 << 32) | w1; a one-word key is w0. Keys of more words sort by stable
// passes of this sort, least significant word group first
// (ops/sort.sort_rows_by_words).
//
// Bound: device-memory bytes. The least traffic is 8 B of key in, 8 B of
// key and 4 B of index out, 20 B a key, against a few integer operations a
// key. This first design is reduce-then-scan, one digit of 8 bits a pass:
//   * histogram_kernel reads every key once and counts all digit positions
//     at once over the whole matrix (the union of the rows), leaving out,
//     and counting apart, the all-ones keys (the pipeline's sentinel). The
//     wrapper (ops/cuda/row_sort_cuda.py) reads it back, its one host
//     synchronise, and plans with ops/cuda/sort_cuda.plan_passes: a digit
//     position where every key that is not all-ones agrees, in every row,
//     is skipped (K=24 keys leave the low 16 bits zero: 6 passes, not 8).
//   * A pass is three launches across all rows, never a launch per row:
//     count_kernel (a block a tile of kTile keys of one row: its 257 bucket
//     counts, all-ones keys in a bucket after 255, so that they land last
//     in their row); scan_kernel (a block a row: the exclusive prefix over
//     (bucket, tile) in that order, so that each tile's run of a bucket
//     starts after the earlier tiles' runs and the smaller buckets); and
//     scatter_kernel (a block a tile again: ranks each key in input order
//     within its bucket, stages the tile in shared memory in bucket order
//     and writes each bucket's run of it to consecutive addresses).
//   * Bytes a key: 8 for the histogram, then for each pass 8 to count, 8 of
//     key (and 4 of index after the first pass) read and 12 written to
//     scatter: 32 B a pass after the first, against the one-sweep design of
//     radix_sort.cu (24 B a pass), which counts and scatters in one kernel.
//   * A warp reads 32 consecutive keys of a row at a time (coalesced);
//     nine ballots group the lanes of one bucket (lanes_like), so that one
//     lane adds their number to a shared count. Stores are what the staging
//     cuts: written key by key, a warp's 32 stores touch 32 sectors;
//     staged, consecutive threads store a bucket's run of the tile (~16
//     keys of a tile of 4096) together. On the flagship's K=24 tiles (127 x
//     131,072, 6 passes; scripts/tune_row_sort.py, NVIDIA H100 80GB HBM3,
//     700.00 W) the staging took the sort from 6.1 to 3.4 ms, the ballots
//     in place of __match_any_sync and radix_sort.cu's histogram scheme to
//     2.1 ms, and tiles of 4096 keys rather than 2048 to 2.0 ms; the
//     scatter then takes ~60 % of the device time and the count ~27 %.
// Any row_len below 2^31 (the index is int32); rows * row_len below 2^31.
//
// Built by allpathslg_tpu_torch/ops/cuda/row_sort_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes through the extern "C" functions at the end.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;     // 256 digit values
constexpr int kBuckets = kRadix + 1;        // + the all-ones bucket, last
constexpr int kMaxPositions = 64 / kRadixBits;
constexpr int kHistWords = kMaxPositions * kRadix + 1;  // + all-ones count
constexpr int kThreads = 256;               // one bucket a thread in scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // 32-key chunks a warp ranks
constexpr int kTile = kThreads * kItems;    // 4096 keys of a row a block
constexpr int kWarpTile = kTile / kWarps;   // 512 consecutive keys a warp
constexpr int kStageBytes = kTile * (8 + 4);  // a tile's keys and indices
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kHistBlocks = 1056;           // 8 per SM of 132
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoDigit = kBuckets;     // lanes past the end of the row
constexpr int kBucketBits = 9;              // bits of a bucket or kNoDigit
constexpr int kHistChunks = 8;   // 32-key chunks a warp loads at once

static_assert(kWarpTile == 32 * kItems, "a warp walks its keys in chunks");
static_assert(kThreads == kRadix, "scans give one digit to each thread");
static_assert(kScanWarps == 32, "the scan's warp sums fit one warp");
static_assert(kNoDigit < (1u << kBucketBits), "lanes_like votes on 9 bits");

__device__ __forceinline__ unsigned bucket_of(uint64_t key, int shift,
                                              uint64_t ones) {
  return key == ones ? kRadix
                     : static_cast<unsigned>((key >> shift) & (kRadix - 1));
}

// The lanes of the warp whose d equals this lane's: nine ballots over the
// bits of d (a bucket or kNoDigit), cheaper here than __match_any_sync.
__device__ __forceinline__ unsigned lanes_like(unsigned d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < kBucketBits; ++b) {
    const unsigned vote = __ballot_sync(kFull, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? vote : ~vote;
  }
  return peers;
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

// hist[p * 256 + d] += the keys, not all-ones, whose digit p is d, for the
// low `positions` digit positions; hist[kHistWords - 1] += the all-ones
// keys. A warp loads kHistChunks chunks of 32 consecutive keys, then counts
// each chunk into the block's shared histogram: when every counted lane of
// the chunk has the same digit (K=24 keys' zero low digits, runs of equal
// keys) one lane adds them all, else each lane adds its own (as in
// radix_sort.cu). One global atomic per bucket per block.
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const uint64_t* __restrict__ keys, int64_t n,
                     int positions, uint64_t ones,
                     uint32_t* __restrict__ hist) {
  __shared__ uint32_t counts[kMaxPositions][kRadix];
  __shared__ uint32_t ones_count;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
#pragma unroll
  for (int p = 0; p < kMaxPositions; ++p) counts[p][tid] = 0;
  if (tid == 0) ones_count = 0;
  __syncthreads();

  constexpr int64_t kGroup = 32 * kHistChunks;  // keys a warp loads at once
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  uint32_t my_ones = 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (tid >> 5);
       g * kGroup < n; g += warps) {  // warp-uniform
    uint64_t key[kHistChunks];
#pragma unroll
    for (int c = 0; c < kHistChunks; ++c) {
      const int64_t i = g * kGroup + c * 32 + lane;
      key[c] = i < n ? keys[i] : 0;
    }
#pragma unroll
    for (int c = 0; c < kHistChunks; ++c) {
      const bool valid = g * kGroup + c * 32 + lane < n;
      const bool is_ones = valid && key[c] == ones;
      const bool counted = valid && !is_ones;
      my_ones += is_ones ? 1u : 0u;
      const unsigned active = __ballot_sync(kFull, counted);
      if (active == 0) continue;
      const int lead = __ffs(active) - 1;
#pragma unroll
      for (int p = 0; p < kMaxPositions; ++p) {
        if (p >= positions) break;
        const unsigned d = static_cast<unsigned>(
            (key[c] >> (p * kRadixBits)) & (kRadix - 1));
        const unsigned d0 = __shfl_sync(kFull, d, lead);
        if (__all_sync(kFull, !counted || d == d0)) {
          if (lane == lead) {
            atomicAdd(&counts[p][d0],
                      static_cast<uint32_t>(__popc(active)));
          }
        } else if (counted) {
          atomicAdd(&counts[p][d], 1u);
        }
      }
    }
  }
  my_ones = __reduce_add_sync(kFull, my_ones);
  if (lane == 0 && my_ones != 0) atomicAdd(&ones_count, my_ones);
  __syncthreads();
  for (int p = 0; p < positions; ++p) {
    const uint32_t v = counts[p][tid];
    if (v != 0) atomicAdd(&hist[p * kRadix + tid], v);
  }
  if (tid == 0 && ones_count != 0) {
    atomicAdd(&hist[kHistWords - 1], ones_count);
  }
}

// Block b is tile (b % tiles) of row (b / tiles). Writes the tile's count of
// each bucket to counts[(row * kBuckets + bucket) * tiles + tile].
__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint64_t* __restrict__ keys, int64_t row_len,
                 int tiles, int shift, uint64_t ones,
                 uint32_t* __restrict__ counts) {
  __shared__ uint32_t hist[kBuckets];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  for (int b = tid; b < kBuckets; b += kThreads) hist[b] = 0;
  __syncthreads();
  const uint64_t* row_keys = keys + row * row_len;
  const int64_t start = static_cast<int64_t>(tile) * kTile + tid;
  uint64_t key[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = start + k * kThreads;
    key[k] = i < row_len ? row_keys[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool valid = start + k * kThreads < row_len;
    const unsigned d = valid ? bucket_of(key[k], shift, ones) : kNoDigit;
    const unsigned peers = lanes_like(d);
    if (valid && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[d], static_cast<uint32_t>(__popc(peers)));
    }
  }
  __syncthreads();
  uint32_t* out = counts + row * kBuckets * tiles + tile;
  for (int b = tid; b < kBuckets; b += kThreads) {
    out[static_cast<int64_t>(b) * tiles] = hist[b];
  }
}

// Block r turns row r's kBuckets * tiles counts, in (bucket, tile) order,
// into their exclusive prefix sums, in place: where each tile's run of each
// bucket starts in the sorted row.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(uint32_t* __restrict__ counts, int tiles) {
  __shared__ uint32_t warp_sums[kScanWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m = static_cast<int64_t>(kBuckets) * tiles;
  uint32_t* c = counts + static_cast<int64_t>(blockIdx.x) * m;
  uint32_t carry = 0;
  for (int64_t base = 0; base < m; base += kScanThreads) {
    const int64_t i = base + tid;
    const uint32_t v = i < m ? c[i] : 0u;
    uint32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t s = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    const uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
    if (i < m) c[i] = carry + before + x - v;
    carry += warp_sums[kScanWarps - 1];
    __syncthreads();  // warp_sums is free for the next chunk
  }
}

// Block b is tile (b % tiles) of row (b / tiles), as in count_kernel. Warp
// w ranks keys [w * kWarpTile, (w + 1) * kWarpTile) of the tile, 32
// consecutive keys at a time, in input order: the lanes of one bucket
// (lanes_like) take the warp's count of it before them plus their
// lower peers. Prefixes over warps and over buckets give each key its
// place in the tile sorted by bucket, where it is staged (dynamic shared
// memory: kStageBytes); then consecutive threads write the staged tile,
// each bucket's run of it after the scan's start of that run (offsets).
// idx_in == nullptr: the index is the key's position in the row.
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const uint64_t* __restrict__ keys_in,
                   const int32_t* __restrict__ idx_in,
                   uint64_t* __restrict__ keys_out,
                   int32_t* __restrict__ idx_out, int64_t row_len, int tiles,
                   int shift, uint64_t ones,
                   const uint32_t* __restrict__ offsets) {
  extern __shared__ uint64_t stage_keys[];              // kTile keys, then
  int32_t* stage_idx = reinterpret_cast<int32_t*>(stage_keys + kTile);
  __shared__ uint32_t warp_count[kWarps][kBuckets];
  __shared__ uint32_t tile_start[kBuckets];  // bucket's start in the tile
  __shared__ uint32_t out_start[kBuckets];   // its run's start in the row
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t tile_n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  for (int b = tid; b < kBuckets; b += kThreads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_count[w][b] = 0;
  }
  __syncthreads();

  const int64_t row_base = row * row_len;
  const int64_t pos0 = static_cast<int64_t>(tile) * kTile + warp * kWarpTile +
                       lane;  // this lane's position in chunk 0
  const unsigned lower_lanes = (1u << lane) - 1u;
  uint64_t key[kItems];
  int32_t idx[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t p = pos0 + c * 32;
    const bool valid = p < row_len;
    key[c] = valid ? keys_in[row_base + p] : 0;
    idx[c] = !valid ? 0
             : idx_in == nullptr ? static_cast<int32_t>(p)
                                 : idx_in[row_base + p];
  }
  uint32_t rank[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const bool valid = pos0 + c * 32 < row_len;
    const unsigned d = valid ? bucket_of(key[c], shift, ones) : kNoDigit;
    const unsigned peers = lanes_like(d);
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0;
    if (valid && lane == leader) {
      before = atomicAdd(&warp_count[warp][d],
                         static_cast<uint32_t>(__popc(peers)));
    }
    rank[c] = __shfl_sync(kFull, before, leader) +
              static_cast<uint32_t>(__popc(peers & lower_lanes));
  }
  __syncthreads();

  // Thread d takes bucket d, thread 0 the all-ones bucket as well: the
  // exclusive prefix over warps (warp_count[w][d] becomes warp w's start
  // within the bucket's run of the tile), the tile's count, and where each
  // bucket starts in the tile and in the row.
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t n = warp_count[w][tid];
    warp_count[w][tid] = count;
    count += n;
  }
  uint32_t count_ones = 0;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t n = warp_count[w][kRadix];
      warp_count[w][kRadix] = count_ones;
      count_ones += n;
    }
  }
  uint32_t tile_rest;
  tile_start[tid] = block_inclusive_scan(count, warp_sums, &tile_rest) - count;
  const uint32_t* tile_offsets = offsets + row * kBuckets * tiles + tile;
  out_start[tid] = tile_offsets[static_cast<int64_t>(tid) * tiles];
  if (tid == 0) {
    tile_start[kRadix] = tile_rest;
    out_start[kRadix] = tile_offsets[static_cast<int64_t>(kRadix) * tiles];
    tile_n = tile_rest + count_ones;
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (pos0 + c * 32 < row_len) {
      const unsigned d = bucket_of(key[c], shift, ones);
      const uint32_t at = tile_start[d] + warp_count[warp][d] + rank[c];
      stage_keys[at] = key[c];
      stage_idx[at] = idx[c];
    }
  }
  __syncthreads();
  for (uint32_t j = tid; j < tile_n; j += kThreads) {
    const uint64_t k = stage_keys[j];
    const unsigned d = bucket_of(k, shift, ones);
    const int64_t at = row_base + out_start[d] + (j - tile_start[d]);
    keys_out[at] = k;
    idx_out[at] = stage_idx[j];
  }
}

uint64_t ones_of(int key_bits) {
  return key_bits == 64 ? ~0ull : (1ull << key_bits) - 1ull;
}

int64_t tiles_of(int64_t row_len) { return (row_len + kTile - 1) / kTile; }

bool valid_args(int64_t rows, int64_t row_len, int key_bits) {
  const int64_t limit = static_cast<int64_t>(1) << 31;
  return rows > 0 && row_len > 0 && rows * row_len < limit &&
         rows * tiles_of(row_len) < limit && (key_bits == 32 || key_bits == 64);
}

}  // namespace

extern "C" {

// 32-bit words of the histogram: 8 x 256 counts, then the all-ones count.
int row_sort_hist_words() { return kHistWords; }

// 32-bit words of the passes' scratch: a count for each (row, bucket, tile).
int64_t row_sort_scratch_words(int64_t rows, int64_t row_len) {
  return rows * kBuckets * tiles_of(row_len);
}

const char* row_sort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Zeroes hist (row_sort_hist_words() words) and counts the digits of
// keys[0..rows * row_len) as unsigned integers of key_bits bits (32 or 64)
// into it: row p (digit p, least significant first) over the keys that are
// not all-ones, then the number of all-ones keys. Runs on `stream` without
// waiting. Returns 0 or the CUDA error of the first call that failed.
int row_sort_histogram(const uint64_t* keys, int64_t rows, int64_t row_len,
                       int key_bits, uint32_t* hist, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!valid_args(rows, row_len, key_bits)) return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaMemsetAsync(hist, 0, kHistWords * sizeof(uint32_t),
                             stream)) != cudaSuccess)
    return err;
  const int64_t n = rows * row_len;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  histogram_kernel<<<static_cast<int>(blocks < kHistBlocks ? blocks
                                                           : kHistBlocks),
                     kThreads, 0, stream>>>(keys, n, key_bits / kRadixBits,
                                            ones_of(key_bits), hist);
  return cudaGetLastError();
}

// Sorts each row of keys_in[rows][row_len] (left untouched) stably by the
// digits at shifts[0..n_passes) in that order, all-ones keys last in their
// row. Pass j writes (keys_a, idx_a) when j is even and (keys_b, idx_b)
// when it is odd, so the result is in a when n_passes is odd; the index is
// the permutation within the row (sorted place -> input place). scratch
// holds row_sort_scratch_words(rows, row_len) words. Runs on `stream`,
// without synchronising. Returns 0 or a CUDA error.
int row_sort_passes(const uint64_t* keys_in, uint64_t* keys_a, int32_t* idx_a,
                    uint64_t* keys_b, int32_t* idx_b, uint32_t* scratch,
                    int64_t rows, int64_t row_len, int key_bits,
                    const int* shifts, int n_passes, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!valid_args(rows, row_len, key_bits) || n_passes < 1 ||
      n_passes > key_bits / kRadixBits)
    return cudaErrorInvalidValue;
  for (int j = 0; j < n_passes; ++j) {
    if (shifts[j] < 0 || shifts[j] >= key_bits || shifts[j] % kRadixBits)
      return cudaErrorInvalidValue;
  }
  const int tiles = static_cast<int>(tiles_of(row_len));
  const unsigned tile_blocks = static_cast<unsigned>(rows * tiles);
  const uint64_t ones = ones_of(key_bits);
  const uint64_t* src_k = keys_in;
  const int32_t* src_i = nullptr;
  cudaError_t err;
  // the scatter's dynamic shared memory limit, once for each device
  static std::atomic<uint64_t> limit_set{0};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? 1ull << device : 0ull;
  if ((limit_set.load() & bit) == 0) {
    if ((err = cudaFuncSetAttribute(
             scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kStageBytes)) != cudaSuccess)
      return err;
    limit_set.fetch_or(bit);
  }
  for (int j = 0; j < n_passes; ++j) {
    uint64_t* dst_k = j % 2 == 0 ? keys_a : keys_b;
    int32_t* dst_i = j % 2 == 0 ? idx_a : idx_b;
    count_kernel<<<tile_blocks, kThreads, 0, stream>>>(src_k, row_len, tiles,
                                                      shifts[j], ones,
                                                      scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_kernel<<<static_cast<unsigned>(rows), kScanThreads, 0, stream>>>(
        scratch, tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scatter_kernel<<<tile_blocks, kThreads, kStageBytes, stream>>>(
        src_k, src_i, dst_k, dst_i, row_len, tiles, shifts[j], ones,
        scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src_k = dst_k;
    src_i = dst_i;
  }
  return 0;
}

}  // extern "C"

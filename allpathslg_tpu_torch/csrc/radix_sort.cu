// Stable LSD radix sort of 64-bit keys carrying an int32 index, for Hopper:
// a one-sweep design after Adinets & Merrill, "Onesweep: a faster least
// significant digit radix sort for GPUs" (2022), written for this repo.
//
// Replaces allpathslg_tpu/ops/pallas/sort_pallas.py::sort_two_words, and
// stands wherever the JAX slice sorts k-mer keys with lax.sort
// (kmer/count.py count_sorted, ops/sort.py sort_by_words, ec/spectrum_ec.py
// strong_table, ops/join.py build_hashed, ec/precorrect.py). A key of two
// uint32 words (w0, w1) is the uint64 (w0 << 32) | w1; a one-word key is w0.
// Keys of three or more words are sorted by stable passes of this sort,
// least significant word group first (ops/sort.py).
//
// Bound: device-memory bytes. The least traffic is 8 B of key in and 8 B of
// key plus 4 B of index out, 20 B a key; an LSD sort reads and writes every
// key once per digit pass, against a few integer operations a key. So the
// design cuts the passes and the bytes of each:
//   * histogram_kernel reads the keys once and counts every digit position
//     at once (8 x 256 buckets for 64-bit keys, 4 x 256 for 32-bit). It
//     leaves out, and counts apart, the keys equal to the all-ones value
//     (2^key_bits - 1, the pipeline's padding sentinel).
//   * The wrapper reads that histogram back (the sort's one host
//     synchronise) and its plan_passes (ops/cuda/sort_cuda.py) runs only the
//     digit positions in which the keys that are not all-ones differ: K=24
//     keys leave the low 16 bits zero, so with sentinels they take 6 passes,
//     not 8. Every pass puts all-ones keys into a 257th bucket after bucket
//     255, so they land last, in input order, whatever they share with the
//     other keys on the planned digits. Doing it in every pass rather than
//     only the last gives the same order (an all-ones key is in the top
//     bucket of the last pass either way) with one bucket rule for all.
//   * Each pass is one kernel, with no separate count or scan: a block takes
//     the next tile from a global counter (so a tile only waits on tiles
//     already started), ranks its keys by bucket in input order, publishes
//     its per-bucket counts to a status array, looks back over earlier
//     tiles for each bucket's global offset (decoupled look-back) and
//     scatters. Bytes a key: 8 for the histogram, 20 for the first pass
//     (the index is the input position, not read), 24 for each later pass;
//     148 for 6 passes against 260 for the 3-kernel passes this replaced.
//   * A warp reads 32 consecutive keys (coalesced); the scatter stages the
//     tile in shared memory in bucket order, so that consecutive threads
//     store each bucket's run of the tile to consecutive addresses.
//   * A block's steps are latency-bound, so they are cut short: nine
//     ballots over a bucket's bits give each lane its peers (in place of
//     __match_any_sync, which was slower here); the index arrives by
//     cp.async into shared memory while the tile is ranked, holding no
//     registers; the look-back reads 8 earlier tiles at a time and comes
//     before the staging, so that a tile's prefix is published early.
//     Tiles of 256 x 24 keys at 2 blocks per SM (128 registers, no
//     spills) were the fastest of the sizes scripts/tune_radix_sort.py
//     tried; 3 blocks per SM spill registers.
// A status word is 32 bits, a 2-bit flag over a 30-bit count, so the
// wrapper refuses n >= 2^30.
//
// Built by allpathslg_tpu_torch/ops/cuda/sort_cuda.py:
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
constexpr int kThreads = 256;               // one digit per thread in scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 24;                  // keys per thread in a pass
constexpr int kTile = kThreads * kItems;    // 6144 keys per tile
constexpr int kWarpTile = kTile / kWarps;   // 768 keys per warp: 24 chunks
constexpr int kStageBytes = kTile * (8 + 4);  // a tile's keys and indices
constexpr int kPassBlocksPerSm = 2;  // register budget of a pass block
constexpr int kLookBackWindow = 8;   // earlier tiles read at once
constexpr int kHistChunks = 8;   // 32-key chunks a warp loads at once
constexpr int kHistBlocks = 1056;  // 8 per SM of 132
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoDigit = kBuckets;     // lanes past the end of the keys
constexpr int kBucketBits = 9;              // bits of a bucket or kNoDigit

// A look-back status word: a flag in the top 2 bits over a count.
constexpr uint32_t kCountMask = (1u << 30) - 1u;
constexpr uint32_t kAggregate = 1u << 30;   // the tile's own count
constexpr uint32_t kPrefix = 2u << 30;      // this and all earlier tiles

static_assert(kThreads == kRadix, "scans give one digit to each thread");
static_assert(kWarpTile == 32 * kItems, "a warp walks its tile in chunks");
static_assert(kTile <= 65536, "two tile places share a register");
static_assert(kNoDigit < (1u << kBucketBits), "ranking votes on 9 bits");

__device__ __forceinline__ unsigned bucket_of(uint64_t key, int shift,
                                              uint64_t ones) {
  return key == ones ? kRadix
                     : static_cast<unsigned>((key >> shift) & (kRadix - 1));
}

// Status words are read and written by blocks that run at once; relaxed
// device-scope accesses keep each read fresh, and a word carries all that
// its reader needs, so no fence orders it against other data.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// An asynchronous 4-byte copy from device to shared memory (cp.async).
__device__ __forceinline__ void copy_async_4(int32_t* dst, const int32_t* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(to), "l"(src) : "memory");
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
// keys) one lane adds them all, else each lane adds its own, so that lanes
// seldom contend for one address. One global atomic per bucket per block.
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
  if (tid == 0 && ones_count != 0) atomicAdd(&hist[kHistWords - 1], ones_count);
}

// Bucket d's keys in the tiles before `tile`: walks back over their status
// words, adding aggregates, until a tile with an inclusive prefix; then
// publishes this tile's inclusive prefix (its own count is `count`). Each
// step reads kLookBackWindow earlier tiles at once: with a tile's other
// steps short, many tiles before it hold only aggregates, and a walk of one
// tile per round trip to L2 would hold up every later tile. Every earlier
// tile belongs to a block that is already running and publishes without
// waiting on later tiles, so the walk ends; should a fault ever break
// that, a wait far beyond any real one traps rather than hangs.
constexpr uint32_t kMaxSpins = 1u << 24;

__device__ uint32_t look_back(uint32_t* status, uint32_t tile, int d,
                              uint32_t count) {
  uint32_t before = 0, spins = 0;
  int64_t p = static_cast<int64_t>(tile) - 1;  // nearest tile not yet added
  while (true) {
    uint32_t s[kLookBackWindow];
#pragma unroll
    for (int w = 0; w < kLookBackWindow; ++w) {
      s[w] = p - w >= 0 ? load_status(status + (p - w) * kBuckets + d) : 0u;
    }
    int added = 0;  // tiles p, p - 1, ... added so far
    bool found = false;
#pragma unroll
    for (int w = 0; w < kLookBackWindow; ++w) {
      const uint32_t flag = s[w] & ~kCountMask;
      if (found || added < w || flag == 0) continue;  // a prefix or a gap
      before += s[w] & kCountMask;
      added = w + 1;
      found = flag == kPrefix;
    }
    if (found) break;
    p -= added;
    if (added == 0 && ++spins == kMaxSpins) __trap();
  }
  store_status(status + static_cast<int64_t>(tile) * kBuckets + d,
               kPrefix | (before + count));
  return before;
}

// One stable pass by bucket_of(key, shift, ones) over one tile of keys.
// `digit_hist` is the histogram's row for this digit position (keys that are
// not all-ones); `status` holds (tiles x kBuckets) words and `next_tile` one,
// all zero at launch. idx_in == nullptr: the index is the input position.
// Dynamic shared memory: kStageBytes. The steps run in the order that lets
// later tiles go on soonest: rank, publish the tile's counts, look back,
// publish its prefix, and only then stage and write the tile.
__global__ void __launch_bounds__(kThreads, kPassBlocksPerSm)
    onesweep_pass_kernel(const uint64_t* __restrict__ keys_in,
                         const int32_t* __restrict__ idx_in,
                         uint64_t* __restrict__ keys_out,
                         int32_t* __restrict__ idx_out, int64_t n, int shift,
                         uint64_t ones,
                         const uint32_t* __restrict__ digit_hist,
                         uint32_t* status, uint32_t* next_tile) {
  extern __shared__ uint64_t stage_keys[];              // kTile keys, then
  int32_t* stage_idx = reinterpret_cast<int32_t*>(stage_keys + kTile);
  __shared__ uint32_t warp_count[kWarps][kBuckets];
  __shared__ uint32_t tile_start[kBuckets];  // bucket's start in the tile
  __shared__ uint32_t out_start[kBuckets];   // its keys' start in the output
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t tile_shared, tile_ones;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) tile_shared = atomicAdd(next_tile, 1u);
  for (int d = tid; d < kBuckets; d += kThreads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_count[w][d] = 0;
  }
  __syncthreads();
  const uint32_t tile = tile_shared;
  if (tile >= gridDim.x) __trap();  // next_tile was not zeroed

  // Warp w holds keys [w * kWarpTile, (w + 1) * kWarpTile) of the tile, in
  // chunks of 32 consecutive keys (coalesced loads) kept in registers. The
  // index travels by cp.async into stage_idx, in input order, while the
  // tile is ranked: it costs no registers and no load waits after the
  // look-back.
  const int local = warp * kWarpTile + lane;  // tile place of chunk 0
  const int64_t base = static_cast<int64_t>(tile) * kTile + local;
  if (idx_in != nullptr) {
#pragma unroll
    for (int c = 0; c < kItems; ++c) {
      if (base + c * 32 < n) {
        copy_async_4(stage_idx + local + c * 32, idx_in + base + c * 32);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  uint64_t key[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = base + c * 32;
    key[c] = i < n ? keys_in[i] : 0;
  }

  // Rank in input order, a chunk at a time: nine ballots over the bits of
  // the bucket give each lane the lanes of its bucket (its peers); the
  // lowest peer adds their number to the warp's count of the bucket and
  // passes the count before to its peers; a lane's rank is that count plus
  // its lower peers.
  const unsigned lower_lanes = (1u << lane) - 1u;
  uint32_t place2[(kItems + 1) / 2];  // 16-bit ranks (later places), 2 a reg
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const unsigned d =
        base + c * 32 < n ? bucket_of(key[c], shift, ones) : kNoDigit;
    unsigned peers = kFull;
#pragma unroll
    for (int b = 0; b < kBucketBits; ++b) {
      const unsigned vote = __ballot_sync(kFull, (d >> b) & 1u);
      peers &= (d >> b) & 1u ? vote : ~vote;
    }
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0;
    if (lane == leader && d != kNoDigit) {
      before = atomicAdd(&warp_count[warp][d],
                         static_cast<uint32_t>(__popc(peers)));
    }
    const uint32_t rank =
        __shfl_sync(kFull, before, leader) + __popc(peers & lower_lanes);
    place2[c / 2] = c % 2 == 0 ? rank : place2[c / 2] | (rank << 16);
  }
  __syncthreads();

  // Thread d takes bucket d, thread 0 the all-ones bucket as well: an
  // exclusive prefix over warps and the tile's count, published at once
  // (tile 0's count is already its inclusive prefix).
  uint32_t* tile_status = status + static_cast<int64_t>(tile) * kBuckets;
  const uint32_t flag = tile == 0 ? kPrefix : kAggregate;
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_count[w][tid];
    warp_count[w][tid] = count;
    count += c;
  }
  store_status(tile_status + tid, flag | count);
  uint32_t count_ones = 0;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_count[w][kRadix];
      warp_count[w][kRadix] = count_ones;
      count_ones += c;
    }
    store_status(tile_status + kRadix, flag | count_ones);
  }
  // where each bucket starts in the tile sorted by bucket, and in the
  // output (the histogram's exclusive scan; all-ones keys after the rest)
  uint32_t tile_rest, all_rest;
  tile_start[tid] =
      block_inclusive_scan(count, warp_sums, &tile_rest) - count;
  const uint32_t h = digit_hist[tid];
  const uint32_t bucket_start =
      block_inclusive_scan(h, warp_sums, &all_rest) - h;
  out_start[tid] =
      bucket_start + (tile == 0 ? 0u : look_back(status, tile, tid, count));
  if (tid == 0) {
    tile_start[kRadix] = tile_rest;
    tile_ones = count_ones;
    out_start[kRadix] =
        all_rest +
        (tile == 0 ? 0u : look_back(status, tile, kRadix, count_ones));
  }
  __syncthreads();

  // Stage the tile in shared memory in bucket order, then write it out by
  // consecutive threads: a bucket's keys of this tile are one run of
  // consecutive addresses in the output, so the stores coalesce. Each
  // rank becomes the key's place in the tile; the index follows once every
  // thread has read its own entries of stage_idx in input order.
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (base + c * 32 < n) {
      const unsigned d = bucket_of(key[c], shift, ones);
      const int half = 16 * (c % 2);
      const uint32_t at = ((place2[c / 2] >> half) & 0xffffu) +
                          tile_start[d] + warp_count[warp][d];
      stage_keys[at] = key[c];
      place2[c / 2] = (place2[c / 2] & ~(0xffffu << half)) | (at << half);
    }
  }
  int32_t idx[kItems];
  if (idx_in != nullptr) asm volatile("cp.async.wait_all;" ::: "memory");
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    idx[c] = idx_in == nullptr ? static_cast<int32_t>(base + c * 32)
                               : stage_idx[local + c * 32];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (base + c * 32 < n) {
      stage_idx[(place2[c / 2] >> (16 * (c % 2))) & 0xffffu] = idx[c];
    }
  }
  __syncthreads();
  const uint32_t tile_n = tile_rest + tile_ones;
  for (uint32_t j = tid; j < tile_n; j += kThreads) {
    const uint64_t k = stage_keys[j];
    const unsigned d = bucket_of(k, shift, ones);
    const uint32_t at = out_start[d] + (j - tile_start[d]);
    keys_out[at] = k;
    idx_out[at] = stage_idx[j];
  }
}

uint64_t ones_of(int key_bits) {
  return key_bits == 64 ? ~0ull : (1ull << key_bits) - 1ull;
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

bool valid_args(int64_t n, int key_bits) {
  return n > 0 && n < (static_cast<int64_t>(1) << 30) &&
         (key_bits == 32 || key_bits == 64);
}

}  // namespace

extern "C" {

// 32-bit words of the histogram buffer: 8 x 256 counts, then the count of
// all-ones keys.
int radix_sort_hist_words() { return kHistWords; }

// 32-bit words of the work buffer of a sort of n keys of key_bits bits:
// the histogram, then the look-back scratch of the most passes it can take.
int64_t radix_sort_work_words(int64_t n, int key_bits) {
  return kHistWords + static_cast<int64_t>(key_bits / kRadixBits) *
                          (tiles_of(n) * kBuckets + 1);
}

const char* radix_sort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The histogram's copy in pinned host memory, one for each host thread
// (pipeline stages sort from several threads at once).
thread_local uint32_t* pinned_hist = nullptr;

// Counts the digits of keys[0..n) as unsigned integers of key_bits bits (32
// or 64) into work[0..radix_sort_hist_words()): row p (digit p, least
// significant first) over the keys that are not all-ones, then the number
// of all-ones keys; then starts its copy to this thread's pinned buffer.
// work holds radix_sort_work_words(n, key_bits) words and is zeroed here,
// the passes' scratch after the histogram with it. Runs on `stream`
// without waiting; radix_sort_read_histogram reads the result. Returns 0
// or the CUDA error of the first call that failed.
int radix_sort_histogram(const uint64_t* keys, int64_t n, int key_bits,
                         uint32_t* work, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!valid_args(n, key_bits)) return cudaErrorInvalidValue;
  uint32_t* hist = work;
  cudaError_t err;
  if ((err = cudaMemsetAsync(work, 0,
                             radix_sort_work_words(n, key_bits) *
                                 sizeof(uint32_t),
                             stream)) != cudaSuccess)
    return err;
  const int64_t per_block = static_cast<int64_t>(kWarps) * 32 * kHistChunks;
  const int64_t blocks = (n + per_block - 1) / per_block;
  histogram_kernel<<<static_cast<int>(blocks < kHistBlocks ? blocks
                                                           : kHistBlocks),
                     kThreads, 0, stream>>>(keys, n, key_bits / kRadixBits,
                                            ones_of(key_bits), hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (pinned_hist == nullptr &&
      (err = cudaMallocHost(&pinned_hist, kHistWords * sizeof(uint32_t))) !=
          cudaSuccess) {
    pinned_hist = nullptr;
    return err;
  }
  return cudaMemcpyAsync(pinned_hist, hist, kHistWords * sizeof(uint32_t),
                         cudaMemcpyDeviceToHost, stream);
}

// Waits for `stream` (the sort's one synchronise) and copies the histogram
// that radix_sort_histogram started on this thread into host_hist
// (radix_sort_hist_words() words). Returns 0 or a CUDA error.
int radix_sort_read_histogram(uint32_t* host_hist, void* stream_handle) {
  if (pinned_hist == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaStreamSynchronize(static_cast<cudaStream_t>(stream_handle));
  if (err != cudaSuccess) return err;
  for (int i = 0; i < kHistWords; ++i) host_hist[i] = pinned_hist[i];
  return 0;
}

// Sorts keys_in[0..n) (left untouched) stably by the digits at shifts[0..
// n_passes) in that order, all-ones keys last, with the work buffer as
// radix_sort_histogram left it. Pass j writes (keys_a, idx_a) when j is
// even and (keys_b, idx_b) when it is odd, so the result is in a when
// n_passes is odd; the index is the permutation (sorted position -> input
// position). Runs on `stream`, without synchronising. Returns 0 or a CUDA
// error.
int radix_sort_passes(const uint64_t* keys_in, uint64_t* keys_a,
                      int32_t* idx_a, uint64_t* keys_b, int32_t* idx_b,
                      uint32_t* work, int64_t n, int key_bits,
                      const int* shifts, int n_passes, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!valid_args(n, key_bits) || n_passes < 1 ||
      n_passes > key_bits / kRadixBits)
    return cudaErrorInvalidValue;
  for (int j = 0; j < n_passes; ++j) {
    if (shifts[j] < 0 || shifts[j] >= key_bits || shifts[j] % kRadixBits)
      return cudaErrorInvalidValue;
  }
  const int64_t tiles = tiles_of(n);
  const int64_t per_pass = tiles * kBuckets + 1;
  const uint32_t* hist = work;
  uint32_t* scratch = work + kHistWords;
  cudaError_t err;
  // the kernel's dynamic shared memory limit, once for each device
  static std::atomic<uint64_t> limit_set{0};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? 1ull << device : 0ull;
  if ((limit_set.load() & bit) == 0) {
    if ((err = cudaFuncSetAttribute(
             onesweep_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kStageBytes)) != cudaSuccess)
      return err;
    limit_set.fetch_or(bit);
  }
  const uint64_t ones = ones_of(key_bits);
  const uint64_t* src_k = keys_in;
  const int32_t* src_i = nullptr;
  for (int j = 0; j < n_passes; ++j) {
    uint64_t* dst_k = j % 2 == 0 ? keys_a : keys_b;
    int32_t* dst_i = j % 2 == 0 ? idx_a : idx_b;
    uint32_t* status = scratch + j * per_pass;
    onesweep_pass_kernel<<<static_cast<unsigned>(tiles), kThreads,
                           kStageBytes, stream>>>(
        src_k, src_i, dst_k, dst_i, n, shifts[j], ones,
        hist + (shifts[j] / kRadixBits) * kRadix, status,
        status + tiles * kBuckets);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src_k = dst_k;
    src_i = dst_i;
  }
  return 0;
}

}  // extern "C"

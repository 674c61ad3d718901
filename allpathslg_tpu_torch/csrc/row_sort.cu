// Stable LSD radix sort of every row of a [rows, row_len] matrix of 64-bit
// keys, each row on its own, with an int32 index within the row, for Hopper:
// radix_sort.cu's one-sweep design (after Adinets & Merrill, "Onesweep: a
// faster least significant digit radix sort for GPUs", 2022) with its
// look-back and its bucket bases scoped to a row.
//
// Replaces the batched row sorts of allpathslg_tpu/ops/bucket_count.py
// (group_keys: lax.sort(dimension=1) of the tiles, :73, and of the bucket
// slabs, :117): an XLA sort, not a Pallas kernel, which the reference keeps
// on-chip a row at a time. A key of two uint32 words (w0, w1) is the uint64
// (w0 << 32) | w1; a one-word key is w0. Keys of more words sort by stable
// passes of this sort, least significant word group first, each pass taking
// the permutation of the one before as its initial index
// (ops/sort.sort_rows_by_words).
//
// Bound: device-memory bytes. The least traffic is 8 B of key in, 8 B of
// key and 4 B of index out, 20 B a key, against a few integer operations a
// key. The design cuts the launches and the bytes of each pass:
//   * histogram_kernel reads every key once: a block counts a span of one
//     row, every digit position at once, into that row's histogram
//     (row_hist: positions x 256 counts, then the row's all-ones count),
//     leaving out the all-ones keys (the pipeline's sentinel).
//   * bases_kernel, a block a row, turns each row's histogram into the
//     start of each bucket in the row for every digit position (bases: 257
//     a position, the all-ones bucket after bucket 255, so that all-ones
//     keys land last in their row), and adds the rows into the union
//     (radix_sort.cu's histogram layout). The wrapper
//     (ops/cuda/row_sort_cuda.py) reads the union back through pinned
//     memory, the sort's one host synchronise, and plans with
//     ops/cuda/sort_cuda.plan_passes: a digit position where every key that
//     is not all-ones agrees, in every row, is skipped (K=24 keys leave the
//     low 16 bits zero: 6 passes, not 8).
//   * One kernel a planned pass across all rows, with no count or scan
//     kernel: a block takes the next tile from a global counter; the tile
//     id maps to (row, tile of the row) in row-major order, so that a tile
//     only waits on tiles already started. The block ranks the tile's keys
//     by bucket in input order, publishes its per-bucket counts to the
//     status words of its tile, looks back over the earlier tiles of its
//     own row for each bucket's prefix (a row's first tile publishes its
//     prefix at once, so a row of one tile never waits), and scatters,
//     staged in shared memory, to the row's bucket base plus that prefix.
//   * Bytes a key: 8 for the histogram, 20 for the first pass (the index is
//     the position in the row, not read; 24 with an initial index), 24 for
//     each later pass: 148 at 6 passes, against 196 for the count, scan and
//     scatter launches a pass that this design replaced. Launches: 2 + one
//     a pass (8 at 6 passes, not 19), and one memset of the scratch.
//   * The block's steps are radix_sort.cu's: a warp reads 32 consecutive
//     keys of a row at a time (coalesced); nine ballots give each lane the
//     lanes of its bucket; the index arrives by cp.async while the tile is
//     ranked; the look-back reads kLookBackWindow earlier tiles at once and
//     comes before the staging; consecutive threads store each bucket's run
//     of the staged tile to consecutive addresses.
//   * Tiles of 256 x 24 keys at 2 blocks per SM with a look-back window of
//     4 were the fastest that scripts/tune_row_sort.py tried (16, 20 and 28
//     keys a thread, windows of 2, 8 and 16, 3 blocks per SM; 28 keys and a
//     window of 16 spill registers).
// A status word is a 2-bit flag over a 30-bit count of one row's keys, so
// row_len is below 2^30; rows * row_len below 2^31.
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
constexpr int kThreads = 256;               // one digit per thread in scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 24;                  // 32-key chunks a warp ranks
constexpr int kTile = kThreads * kItems;    // 6144 keys of a row a tile
constexpr int kWarpTile = kTile / kWarps;   // 768 consecutive keys a warp
constexpr int kStageBytes = kTile * (8 + 4);  // a tile's keys and indices
constexpr int kPassBlocksPerSm = 2;  // register budget of a pass block
constexpr int kLookBackWindow = 4;   // earlier tiles read at once
constexpr int kHistChunks = 8;       // 32-key chunks a warp loads at once
constexpr int kHistGroups = 8;       // such loads a warp makes in a span
constexpr int64_t kHistSpan =        // keys of a row a histogram block counts
    static_cast<int64_t>(kThreads) * kHistChunks * kHistGroups;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoDigit = kBuckets;     // lanes past the end of the row
constexpr int kBucketBits = 9;              // bits of a bucket or kNoDigit

// A look-back status word: a flag in the top 2 bits over a count.
constexpr uint32_t kCountMask = (1u << 30) - 1u;
constexpr uint32_t kAggregate = 1u << 30;   // the tile's own count
constexpr uint32_t kPrefix = 2u << 30;      // this and the row's earlier tiles

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

// Block b counts keys [s * kHistSpan, (s + 1) * kHistSpan) of row r, where
// r = b / spans and s = b % spans, into the row's histogram
// row_hist[r * (positions * 256 + 1) ...]: word p * 256 + d += the keys,
// not all-ones, whose digit p is d (p < positions); word positions * 256 +=
// the all-ones keys. A warp loads kHistChunks chunks of 32 consecutive keys,
// then counts each chunk into the block's shared histogram: when every
// counted lane of the chunk has the same digit (K=24 keys' zero low digits,
// runs of equal keys) one lane adds them all, else each lane adds its own
// (as in radix_sort.cu). One global atomic per nonzero bucket per block.
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const uint64_t* __restrict__ keys, int64_t row_len,
                     int spans, int positions, uint64_t ones,
                     uint32_t* __restrict__ row_hist) {
  __shared__ uint32_t counts[kMaxPositions][kRadix];
  __shared__ uint32_t ones_count;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
#pragma unroll
  for (int p = 0; p < kMaxPositions; ++p) counts[p][tid] = 0;
  if (tid == 0) ones_count = 0;
  __syncthreads();

  constexpr int64_t kGroup = 32 * kHistChunks;  // keys a warp loads at once
  const int64_t row = blockIdx.x / spans;
  const int64_t first = static_cast<int64_t>(blockIdx.x % spans) * kHistSpan;
  const int64_t end =
      first + kHistSpan < row_len ? first + kHistSpan : row_len;
  const uint64_t* row_keys = keys + row * row_len;
  uint32_t my_ones = 0;
  for (int64_t g = first + (tid >> 5) * kGroup; g < end;
       g += kWarps * kGroup) {  // warp-uniform
    uint64_t key[kHistChunks];
#pragma unroll
    for (int c = 0; c < kHistChunks; ++c) {
      const int64_t i = g + c * 32 + lane;
      key[c] = i < end ? row_keys[i] : 0;
    }
#pragma unroll
    for (int c = 0; c < kHistChunks; ++c) {
      const bool valid = g + c * 32 + lane < end;
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
  uint32_t* h = row_hist + row * (positions * kRadix + 1);
  for (int p = 0; p < positions; ++p) {
    const uint32_t v = counts[p][tid];
    if (v != 0) atomicAdd(&h[p * kRadix + tid], v);
  }
  if (tid == 0 && ones_count != 0) {
    atomicAdd(&h[positions * kRadix], ones_count);
  }
}

// Block r: for each digit position p, the exclusive prefix of row r's
// histogram over the 257 buckets, bases[(r * positions + p) * 257 + d],
// the all-ones bucket's start being the row's count of the other keys;
// and row r's counts added into the union hist (kHistWords words, zeroed
// before).
__global__ void __launch_bounds__(kThreads)
    bases_kernel(const uint32_t* __restrict__ row_hist, int positions,
                 uint32_t* __restrict__ bases, uint32_t* __restrict__ hist) {
  __shared__ uint32_t warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const uint32_t* h = row_hist + row * (positions * kRadix + 1);
  uint32_t* b = bases + row * positions * kBuckets;
  for (int p = 0; p < positions; ++p) {
    const uint32_t v = h[p * kRadix + tid];
    if (v != 0) atomicAdd(&hist[p * kRadix + tid], v);
    uint32_t total;
    b[p * kBuckets + tid] = block_inclusive_scan(v, warp_sums, &total) - v;
    if (tid == 0) b[p * kBuckets + kRadix] = total;
  }
  const uint32_t n_ones = h[positions * kRadix];
  if (tid == 0 && n_ones != 0) atomicAdd(&hist[kHistWords - 1], n_ones);
}

// Bucket d's keys in the row's tiles before `tile`: walks back over their
// status words (row_status: the row's tile 0 first), adding aggregates,
// until a tile with an inclusive prefix; then, when `publish`, publishes
// this tile's inclusive prefix (its own count is `count`). Each step reads
// kLookBackWindow earlier tiles at once. Every earlier tile of the row
// belongs to a block that is already running and publishes without waiting
// on later tiles, and the row's tile 0 publishes a prefix at once, so the
// walk ends; should a fault ever break that, a wait far beyond any real
// one traps rather than hangs.
constexpr uint32_t kMaxSpins = 1u << 24;

__device__ uint32_t look_back(uint32_t* row_status, int tile, int d,
                              uint32_t count, bool publish) {
  uint32_t before = 0, spins = 0;
  int p = tile - 1;  // nearest tile not yet added
  while (true) {
    uint32_t s[kLookBackWindow];
#pragma unroll
    for (int w = 0; w < kLookBackWindow; ++w) {
      s[w] = p - w >= 0
                 ? load_status(row_status +
                               static_cast<int64_t>(p - w) * kBuckets + d)
                 : 0u;
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
  if (publish) {
    store_status(row_status + static_cast<int64_t>(tile) * kBuckets + d,
                 kPrefix | (before + count));
  }
  return before;
}

// One stable pass by bucket_of(key, shift, ones) over one tile of one row.
// `bases` is bases_kernel's output at this pass's digit position (row r's
// 257 starts at r * bases_stride); `status` holds (rows x tiles x
// kBuckets) words and `next_tile` one, all zero at launch; the grid is
// rows x tiles blocks. idx_in == nullptr: the index is the key's position
// in its row. Dynamic shared memory: kStageBytes. The steps run in the
// order that lets later tiles go on soonest: rank, publish the tile's
// counts, look back, publish its prefix, and only then stage and write.
__global__ void __launch_bounds__(kThreads, kPassBlocksPerSm)
    pass_kernel(const uint64_t* __restrict__ keys_in,
                const int32_t* __restrict__ idx_in,
                uint64_t* __restrict__ keys_out,
                int32_t* __restrict__ idx_out, int64_t row_len, int tiles,
                int shift, uint64_t ones, const uint32_t* __restrict__ bases,
                int bases_stride, uint32_t* status, uint32_t* next_tile) {
  extern __shared__ uint64_t stage_keys[];              // kTile keys, then
  int32_t* stage_idx = reinterpret_cast<int32_t*>(stage_keys + kTile);
  __shared__ uint32_t warp_count[kWarps][kBuckets];
  __shared__ uint32_t tile_start[kBuckets];  // bucket's start in the tile
  __shared__ uint32_t out_start[kBuckets];   // its keys' start in the row
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t id_shared, tile_ones;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) id_shared = atomicAdd(next_tile, 1u);
  for (int d = tid; d < kBuckets; d += kThreads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_count[w][d] = 0;
  }
  __syncthreads();
  const uint32_t id = id_shared;
  if (id >= gridDim.x) __trap();  // next_tile was not zeroed
  const int64_t row = id / static_cast<uint32_t>(tiles);
  const int tile = static_cast<int>(id % static_cast<uint32_t>(tiles));
  const int64_t row_base = row * row_len;

  // Warp w holds keys [w * kWarpTile, (w + 1) * kWarpTile) of the tile, in
  // chunks of 32 consecutive keys (coalesced loads) kept in registers. The
  // index travels by cp.async into stage_idx, in input order, while the
  // tile is ranked.
  const int local = warp * kWarpTile + lane;  // tile place of chunk 0
  const int64_t pos0 = static_cast<int64_t>(tile) * kTile + local;
  if (idx_in != nullptr) {
#pragma unroll
    for (int c = 0; c < kItems; ++c) {
      if (pos0 + c * 32 < row_len) {
        copy_async_4(stage_idx + local + c * 32,
                     idx_in + row_base + pos0 + c * 32);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  uint64_t key[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int64_t i = pos0 + c * 32;
    key[c] = i < row_len ? keys_in[row_base + i] : 0;
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
        pos0 + c * 32 < row_len ? bucket_of(key[c], shift, ones) : kNoDigit;
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
  // exclusive prefix over warps and the tile's count, published at once for
  // the row's later tiles (tile 0's count is already its inclusive prefix;
  // the row's last tile has no reader).
  uint32_t* row_status = status + (static_cast<int64_t>(id) - tile) * kBuckets;
  uint32_t* tile_status = row_status + static_cast<int64_t>(tile) * kBuckets;
  const bool publish = tile + 1 < tiles;
  const uint32_t flag = tile == 0 ? kPrefix : kAggregate;
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_count[w][tid];
    warp_count[w][tid] = count;
    count += c;
  }
  if (publish) store_status(tile_status + tid, flag | count);
  uint32_t count_ones = 0;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_count[w][kRadix];
      warp_count[w][kRadix] = count_ones;
      count_ones += c;
    }
    if (publish) store_status(tile_status + kRadix, flag | count_ones);
  }
  // where each bucket starts in the tile sorted by bucket, and in the row
  // (the row's base of the bucket plus the row's earlier tiles' keys in it)
  uint32_t tile_rest;
  tile_start[tid] =
      block_inclusive_scan(count, warp_sums, &tile_rest) - count;
  const uint32_t* row_bases = bases + row * bases_stride;
  out_start[tid] =
      row_bases[tid] +
      (tile == 0 ? 0u : look_back(row_status, tile, tid, count, publish));
  if (tid == 0) {
    tile_start[kRadix] = tile_rest;
    tile_ones = count_ones;
    out_start[kRadix] =
        row_bases[kRadix] +
        (tile == 0 ? 0u
                   : look_back(row_status, tile, kRadix, count_ones, publish));
  }
  __syncthreads();

  // Stage the tile in shared memory in bucket order, then write it out by
  // consecutive threads: a bucket's keys of this tile are one run of
  // consecutive addresses in the row, so the stores coalesce. Each rank
  // becomes the key's place in the tile; the index follows once every
  // thread has read its own entries of stage_idx in input order.
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (pos0 + c * 32 < row_len) {
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
    idx[c] = idx_in == nullptr ? static_cast<int32_t>(pos0 + c * 32)
                               : stage_idx[local + c * 32];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    if (pos0 + c * 32 < row_len) {
      stage_idx[(place2[c / 2] >> (16 * (c % 2))) & 0xffffu] = idx[c];
    }
  }
  __syncthreads();
  const uint32_t tile_n = tile_rest + tile_ones;
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

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool valid_args(int64_t rows, int64_t row_len, int key_bits) {
  const int64_t limit = static_cast<int64_t>(1) << 31;
  return rows > 0 && row_len > 0 && row_len < (static_cast<int64_t>(1) << 30)
         && rows * row_len < limit && (key_bits == 32 || key_bits == 64);
}

}  // namespace

extern "C" {

// Keys of a row in a pass kernel's tile.
int row_sort_tile_keys() { return kTile; }

// 32-bit words of the union histogram: 8 x 256 counts, then the all-ones
// count (radix_sort.cu's layout).
int row_sort_hist_words() { return kHistWords; }

const char* row_sort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The union histogram's copy in pinned host memory, one for each host
// thread.
thread_local uint32_t* pinned_hist = nullptr;

// The work buffer is laid out by the wrapper (row_sort_cuda.scratch_layout):
// hist (the union), row_hist, status (one region a planned pass: tiles x
// kBuckets words, then the pass's tile counter), then bases; everything
// before bases, `zero_words` words, is zeroed here. Counts the digits of
// each row of keys[rows][row_len] as unsigned integers of key_bits bits (32
// or 64) into row_hist, turns them into bases and adds them into hist
// (row p of it: digit p, least significant first, over the keys that are
// not all-ones; then the number of all-ones keys), then starts hist's copy
// to this thread's pinned buffer. Runs on `stream` without waiting;
// row_sort_read_histogram reads the copy. Returns 0 or the CUDA error of
// the first call that failed.
int row_sort_histogram(const uint64_t* keys, int64_t rows, int64_t row_len,
                       int key_bits, uint32_t* work, int64_t zero_words,
                       uint32_t* row_hist, uint32_t* bases,
                       void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!valid_args(rows, row_len, key_bits)) return cudaErrorInvalidValue;
  uint32_t* hist = work;
  const int positions = key_bits / kRadixBits;
  cudaError_t err;
  if ((err = cudaMemsetAsync(work, 0, zero_words * sizeof(uint32_t),
                             stream)) != cudaSuccess)
    return err;
  const int spans = static_cast<int>(ceil_div(row_len, kHistSpan));
  histogram_kernel<<<static_cast<unsigned>(rows * spans), kThreads, 0,
                     stream>>>(keys, row_len, spans, positions,
                               ones_of(key_bits), row_hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bases_kernel<<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      row_hist, positions, bases, hist);
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

// Waits for `stream` (the sort's one synchronise) and copies the union
// histogram that row_sort_histogram started on this thread into host_hist
// (row_sort_hist_words() words). Returns 0 or a CUDA error.
int row_sort_read_histogram(uint32_t* host_hist, void* stream_handle) {
  if (pinned_hist == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaStreamSynchronize(static_cast<cudaStream_t>(stream_handle));
  if (err != cudaSuccess) return err;
  for (int i = 0; i < kHistWords; ++i) host_hist[i] = pinned_hist[i];
  return 0;
}

// Sorts each row of keys_in[rows][row_len] (left untouched) stably by the
// digits at shifts[0..n_passes) in that order, all-ones keys last in their
// row, with bases and status as row_sort_histogram left them (status: pass
// j's region at j * status_stride words, each of at least rows * tiles *
// 257 + 1, tiles = ceil(row_len / row_sort_tile_keys())). Pass j writes (keys_a,
// idx_a) when j is even and (keys_b, idx_b) when it is odd, so the result
// is in a when n_passes is odd. The index is the permutation within the row
// (sorted place -> input place), composed with idx_init[rows][row_len] when
// it is not null (sorted place -> idx_init at the input place). Runs on
// `stream`, without synchronising. Returns 0 or a CUDA error.
int row_sort_passes(const uint64_t* keys_in, const int32_t* idx_init,
                    uint64_t* keys_a, int32_t* idx_a, uint64_t* keys_b,
                    int32_t* idx_b, const uint32_t* bases, uint32_t* status,
                    int64_t status_stride, int64_t rows, int64_t row_len, int key_bits,
                    const int* shifts, int n_passes, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int positions = key_bits / kRadixBits;
  if (!valid_args(rows, row_len, key_bits) || n_passes < 1 ||
      n_passes > positions)
    return cudaErrorInvalidValue;
  for (int j = 0; j < n_passes; ++j) {
    if (shifts[j] < 0 || shifts[j] >= key_bits || shifts[j] % kRadixBits)
      return cudaErrorInvalidValue;
  }
  const int tiles = static_cast<int>(ceil_div(row_len, kTile));
  const int64_t grid = rows * tiles;
  if (grid >= (static_cast<int64_t>(1) << 31)) return cudaErrorInvalidValue;
  if (status_stride < grid * kBuckets + 1) return cudaErrorInvalidValue;
  cudaError_t err;
  // the pass kernel's dynamic shared memory limit, once for each device
  static std::atomic<uint64_t> limit_set{0};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? 1ull << device : 0ull;
  if ((limit_set.load() & bit) == 0) {
    if ((err = cudaFuncSetAttribute(
             pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kStageBytes)) != cudaSuccess)
      return err;
    limit_set.fetch_or(bit);
  }
  const uint64_t ones = ones_of(key_bits);
  const uint64_t* src_k = keys_in;
  const int32_t* src_i = idx_init;
  for (int j = 0; j < n_passes; ++j) {
    uint64_t* dst_k = j % 2 == 0 ? keys_a : keys_b;
    int32_t* dst_i = j % 2 == 0 ? idx_a : idx_b;
    uint32_t* pass_status = status + j * status_stride;
    pass_kernel<<<static_cast<unsigned>(grid), kThreads, kStageBytes,
                  stream>>>(src_k, src_i, dst_k, dst_i, row_len, tiles,
                            shifts[j], ones,
                            bases + (shifts[j] / kRadixBits) * kBuckets,
                            positions * kBuckets, pass_status,
                            pass_status + grid * kBuckets);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src_k = dst_k;
    src_i = dst_i;
  }
  return 0;
}

}  // extern "C"

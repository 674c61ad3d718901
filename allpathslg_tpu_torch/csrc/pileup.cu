// Per-column base votes of reads placed on the contigs (polish's pileup)
// for Hopper.
//
// Replaces no TPU kernel: the JAX package counts these votes on the host
// (allpathslg_tpu/asm/polish.py::_pileup_segments, a numpy bincount over
// [reads, L] temporaries), and the port did too before this kernel. It was
// added because that host count held the card idle through most of the
// polish stage.
//
// Contract (ops/cuda/pileup_cuda.py, whose plain version is the same
// count in PyTorch): the n_reads rows are placed reads, sorted by
// starts[], the leftmost global position each can cover,
// offsets[contig] + (rc ? anchor - (len - 1) : anchor); the host gathers
// them so (asm/polish.py), the rows that can reach the segment only.
// Base j < len of read r (len = lengths[r], at most the row width
// max_len) has code c = codes[r, j]; codes >= 4 are skipped, and a
// reverse-complemented read votes 3 - c at global position
// offsets[contig] + anchor - j (anchor + j forward). A vote counts only inside its own contig, [offsets[contig],
// offsets[contig + 1]), and inside the segment [s0, s1); votes[p - s0, b]
// (int32 [s1 - s0, 4]) is the number of votes for base b at position p.
// Every column of the segment is written.
//
// What bounds it: bytes. Each base of a read is read once and each
// column written once as 16 B; per read it needs 13 B of alignlet. At the
// shape of a 400 kb assembly (~88,000 placed reads of 101-203 bases, one
// segment; chip_smoke.py's phase 6b) that is ~21 MB: 6.2 us at 3.35 TB/s.
//
// Design: a gather, one thread a column, so that no vote is an atomic.
// - A warp owns 32 consecutive columns [cw, cw + 32), lane l column
//   cw + l, and keeps the column's four counts in registers until its one
//   16-byte write (a warp writes 512 contiguous bytes).
// - The reads that can reach [cw, cw + 32) are those with start in
//   [cw - max_len, cw + 32): a contiguous range of the sorted rows,
//   found by two 32-way searches of the warp (warp_lower_bound, ~5
//   dependent loads each at 10^5 reads).
// - The warp takes the range 32 reads at a time: lane l loads read l's
//   alignlet (and its contig's bounds), and the warp walks the
//   32 reads, taking each one's fields from its lane by shuffles. For a
//   read, lane l reads the one code that lands on its column, if any: the
//   32 lanes read 32 consecutive bytes of the row (reversed for a
//   reverse-complemented read), one or two 32-byte sectors. kAhead reads'
//   codes are loaded before any is counted, so their latencies overlap.
// The first design scattered instead: a block of 16 warps counted a tile
// of 1,024 columns with shared-memory atomics, a warp voting a read's
// bases 32 columns a step. It gave the same votes in 0.080 ms at 400 kb
// where this design took 0.062-0.064 ms, in one call (NVIDIA H100 80GB
// HBM3, 700 W), and needed rows padded to 4-byte words.
//
// Built by allpathslg_tpu_torch/ops/cuda/nvcc.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (ops/cuda/pileup_cuda.py) through the extern "C"
// functions at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, 32 columns each
constexpr int kWarps = kThreads / 32;
// reads whose codes load together: 8 took 0.070 ms at 400 kb, 4 took
// 0.077 and 2 0.078 (torch.profiler, one call, NVIDIA H100 80GB HBM3)
constexpr int kAhead = 8;
constexpr unsigned kAll = 0xffffffffu;

// First index i in [lo, hi) with a[i] >= x (hi when none), a sorted, found
// by the 32 lanes of a warp together: each step splits [lo, hi) into 32
// parts, and a ballot of "part l's last element < x" counts the parts
// wholly below x, so the part that holds the answer is kept.
__device__ __forceinline__ int64_t warp_lower_bound(const int64_t* a,
                                                    int64_t lo, int64_t hi,
                                                    int64_t x, int lane) {
  while (hi - lo > 32) {
    const int64_t len = hi - lo;
    const bool below = a[lo + len * (lane + 1) / 32 - 1] < x;
    const int k = __popc(__ballot_sync(kAll, below));
    const int64_t part_lo = lo + len * k / 32;
    if (k < 32) hi = lo + len * (k + 1) / 32;
    lo = part_lo;
  }
  const bool below = lo + lane < hi && a[lo + lane] < x;
  return lo + __popc(__ballot_sync(kAll, below));
}

__global__ void __launch_bounds__(kThreads) pileup_kernel(
    const int64_t* __restrict__ offsets, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ contig,
    const int32_t* __restrict__ anchor, const uint8_t* __restrict__ rc,
    const int64_t* __restrict__ starts, int64_t n_reads, int max_len,
    int64_t s0, int64_t s1, int32_t* __restrict__ votes) {
  const int lane = threadIdx.x & 31;
  const int64_t cw =
      s0 + (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
               32;
  if (cw >= s1) return;   // the whole warp
  const int64_t col = cw + lane;
  const int64_t lo =
      warp_lower_bound(starts, 0, n_reads, cw - max_len, lane);
  const int64_t hi = warp_lower_bound(starts, lo, n_reads, cw + 32, lane);

  int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
  for (int64_t r0 = lo; r0 < hi; r0 += 32) {
    // lane l fetches the alignlet of read r0 + l; a lane past the range
    // keeps length 0, which reaches no column
    int my_len = 0, my_rc = 0;
    long long my_cs = 0, my_ce = 0, my_base0 = 0;
    if (r0 + lane < hi) {
      const int64_t r = r0 + lane;
      my_len = min(lengths[r], max_len);
      my_rc = rc[r];
      const int ci = contig[r];
      my_cs = offsets[ci];
      my_ce = offsets[ci + 1];
      my_base0 = my_cs + anchor[r];   // base 0's column
    }
    const int n_reads = hi - r0 < 32 ? static_cast<int>(hi - r0) : 32;
    for (int q0 = 0; q0 < n_reads; q0 += kAhead) {   // uniform in the warp
      uint32_t code[kAhead];
      bool flip[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int q = q0 + u;   // < 32; past n_reads, a length-0 lane
        const int len = __shfl_sync(kAll, my_len, q);
        flip[u] = __shfl_sync(kAll, my_rc, q) != 0;
        const int64_t cs = __shfl_sync(kAll, my_cs, q);
        const int64_t ce = __shfl_sync(kAll, my_ce, q);
        const int64_t base0 = __shfl_sync(kAll, my_base0, q);
        const int64_t j = flip[u] ? base0 - col : col - base0;
        const bool lands = j >= 0 && j < len && col >= cs && col < ce &&
                           col < s1;
        code[u] = lands ? codes[(r0 + q) * max_len + j] : 4u;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        // a code >= 4 (and its flip, which wraps) counts nowhere
        const uint32_t b = flip[u] ? 3u - code[u] : code[u];
        n0 += b == 0;
        n1 += b == 1;
        n2 += b == 2;
        n3 += b == 3;
      }
    }
  }
  if (col < s1) {
    reinterpret_cast<int4*>(votes)[col - s0] = make_int4(n0, n1, n2, n3);
  }
}

}  // namespace

extern "C" {

const char* pileup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch over the segment [s0, s1) on `stream`. codes is uint8
// [n_reads, max_len], row-major and contiguous; offsets int64
// [n_contigs + 1]; lengths, contig, anchor int32, rc uint8 and starts
// int64 [n_reads], the rows sorted by starts; votes int32 [s1 - s0, 4],
// 16-byte aligned. Returns the launch's cudaError_t (0 on success).
int pileup_launch(const int64_t* offsets, const uint8_t* codes,
                  const int32_t* lengths, const int32_t* contig,
                  const int32_t* anchor, const uint8_t* rc,
                  const int64_t* starts, int64_t n_reads, int max_len,
                  int64_t s0, int64_t s1, int32_t* votes, void* stream) {
  if (s1 <= s0) return 0;
  if (max_len < 0 || s0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (s1 - s0 + 32 * kWarps - 1) / (32 * kWarps);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  pileup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      offsets, codes, lengths, contig, anchor, rc, starts, n_reads, max_len,
      s0, s1, votes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// General integer-cost banded glocal DP for Hopper.
//
// Replaces allpathslg_tpu/ops/pallas/banded_pallas.py::banded_align_pallas
// (its _kernel and _min_prefix). Same contract as the plain version
// allpathslg_tpu_torch/ops/banded.py::banded_align: for each problem b,
// align the query q[b, :q_len[b]] glocally into the target t[b, :t_len[b]]
// around the diagonal offset[b] with band half-width `band`, a mismatch
// costing sub_cost and a gap base gap_cost; return the least cost and the
// exclusive target end column reaching it, or (1 << 20, -1) when no
// in-band path exists. Codes are compared as they are: a query code 4
// matches a target code 4 (unlike csrc/banded_bp.cu).
//
// Recurrence (the plain version's, row by row): slot k in [0, K), K =
// 2 * band + 1, of row r is target column j = r + off - band + k, so
//   diag = prev[k] + (q[r-1] == t[j-1] ? 0 : sub_cost)
//   up   = prev[k+1] + gap_cost            (BIG + gap_cost past slot K-1)
//   m    = in_t ? min(diag, up) : BIG,      in_t = 1 <= j <= t_len
//   m    = r * gap_cost                     where j == 0
//   row  = min(m, k * gap + prefix-min over k' <= k of (m[k'] - k' * gap))
//   row  = (in_t || j == 0) ? min(row, BIG) : BIG
// Row 0 is 0 where 0 <= j <= t_len. The answer row is row q_len (row 0 when
// q_len is 0 or outside [1, Lq]); the final minimum is taken over the slots
// with 0 <= q_len + off - band + k <= t_len, ties to the lowest slot.
// Offsets outside [-(Lq + band), Lt + band] are clamped and the problem
// gets t_len = -1, so it reports (1 << 20, -1), as the TPU kernel does.
//
// Design: one warp per problem. Lane l holds slots l*S .. l*S + S - 1 in
// registers (S = 1, 2, 4, 8 or 16, the least power of two with 32 * S >=
// K; the largest band is 255). A row costs S target-byte loads per lane
// (consecutive across the warp, L1-cached; the query byte is one broadcast
// load), one __shfl_down_sync for the `up` term across lanes, and the
// horizontal closure as a sequential prefix inside the lane, a 5-step
// __shfl_up_sync scan of the lane minima and a combine. All arithmetic is
// int32. The TPU kernel's lane blocks of 128 problems, its roll-based
// target alignment and its 8-row grid steps serve the TPU's VMEM and are
// not carried over.
//
// Bound: operations. At patch_gaps' band 96 (K = 193 of 256 slots) a row
// is ~20 integer operations per slot and 6 shuffles per lane; bytes are
// one query byte and K target bytes per row, served from L1. Several
// problems per warp and shared-memory staging of the target are left for
// later work.
//
// Built by allpathslg_tpu_torch/ops/cuda/nvcc.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (ops/cuda/banded_general_cuda.py) through the
// extern "C" functions at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kWarps = 4;  // problems per block
constexpr int kMaxBand = 255;
constexpr int kCarryNone = 0x3fffffff;  // larger than any prefix value
constexpr unsigned kFull = 0xffffffffu;

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
banded_general_kernel(const uint8_t* __restrict__ q,
                      const uint8_t* __restrict__ t,
                      const int32_t* __restrict__ q_len,
                      const int32_t* __restrict__ t_len,
                      const int32_t* __restrict__ offset,
                      int32_t* __restrict__ cost_out,
                      int32_t* __restrict__ t_end_out, int n_problems, int Lq,
                      int Lt, int band, int sub_cost, int gap_cost) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_problems) return;  // uniform across the warp
  const int K = 2 * band + 1;
  const uint8_t* qrow = q + static_cast<size_t>(b) * Lq;
  const uint8_t* trow = t + static_cast<size_t>(b) * Lt;

  const int ql = q_len[b];
  int tl = t_len[b];
  int off = offset[b];
  const int off_min = -(Lq + band), off_max = Lt + band;
  if (off < off_min || off > off_max) tl = -1;
  off = min(max(off, off_min), off_max);
  const int n_rows = (ql >= 1 && ql <= Lq) ? ql : 0;
  const int k0 = lane * S;  // this lane's first slot

  int prev[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = k0 + s;
    const int j = off - band + k;
    prev[s] = (k < K && j >= 0 && j <= tl) ? 0 : kBig;
  }

  for (int r = 1; r <= n_rows; ++r) {
    const int qc = qrow[r - 1];
    const int jbase = r + off - band;
    int from_next = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 31) from_next = kBig;
    int m[S];
    int run[S];
    bool keep[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s;
      const int j = jbase + k;
      const bool live = k < K;
      const bool in_t = live && j >= 1 && j <= tl;
      const int up = (s + 1 < S ? prev[s + 1] : from_next) + gap_cost;
      int v = kBig;
      if (in_t) {
        const int sub = (static_cast<int>(trow[j - 1]) == qc) ? 0 : sub_cost;
        v = min(prev[s] + sub, up);
      }
      if (live && j == 0) v = r * gap_cost;
      m[s] = v;
      keep[s] = in_t || (live && j == 0);
      const int x = v - k * gap_cost;
      run[s] = s == 0 ? x : min(run[s - 1], x);
    }
    // exclusive min over the lanes below: inclusive scan, then shift
    int scan = run[S - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int other = __shfl_up_sync(kFull, scan, d);
      if (lane >= d) scan = min(scan, other);
    }
    int carry = __shfl_up_sync(kFull, scan, 1);
    if (lane == 0) carry = kCarryNone;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s;
      const int closed = min(m[s], min(carry, run[s]) + k * gap_cost);
      prev[s] = keep[s] ? min(closed, kBig) : kBig;
    }
  }

  // final: least cost over the slots whose end column lies in the target,
  // ties to the lowest slot
  const int jbase = ql + off - band;
  int best = kBig + 1, best_k = K;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = k0 + s;
    const int jf = jbase + k;
    const int v = (k < K && jf >= 0 && jf <= tl) ? prev[s] : kBig;
    if (k < K && v < best) {
      best = v;
      best_k = k;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, d);
    const int ok = __shfl_xor_sync(kFull, best_k, d);
    if (ov < best || (ov == best && ok < best_k)) {
      best = ov;
      best_k = ok;
    }
  }
  if (lane == 0) {
    cost_out[b] = best;
    t_end_out[b] = best < kBig ? jbase + best_k : -1;
  }
}

template <int S>
void launch(const uint8_t* q, const uint8_t* t, const int32_t* q_len,
            const int32_t* t_len, const int32_t* offset, int32_t* cost,
            int32_t* t_end, int n_problems, int Lq, int Lt, int band,
            int sub_cost, int gap_cost, cudaStream_t stream) {
  const int blocks = (n_problems + kWarps - 1) / kWarps;
  banded_general_kernel<S><<<blocks, kWarps * 32, 0, stream>>>(
      q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt, band,
      sub_cost, gap_cost);
}

}  // namespace

extern "C" {

const char* banded_general_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int banded_general_max_band() { return kMaxBand; }

// One launch over n_problems problems on `stream`; q is uint8 [B, Lq] and
// t uint8 [B, Lt], row-major and contiguous; q_len, t_len, offset, cost and
// t_end int32 [B]. Returns the launch's cudaError_t (0 on success).
int banded_general_launch(const uint8_t* q, const uint8_t* t,
                          const int32_t* q_len, const int32_t* t_len,
                          const int32_t* offset, int32_t* cost,
                          int32_t* t_end, int n_problems, int Lq, int Lt,
                          int band, int sub_cost, int gap_cost, void* stream) {
  if (n_problems <= 0) return 0;
  if (band < 0 || band > kMaxBand || Lq < 0 || Lt < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = 2 * band + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= 32) {
    launch<1>(q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt,
              band, sub_cost, gap_cost, st);
  } else if (K <= 64) {
    launch<2>(q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt,
              band, sub_cost, gap_cost, st);
  } else if (K <= 128) {
    launch<4>(q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt,
              band, sub_cost, gap_cost, st);
  } else if (K <= 256) {
    launch<8>(q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt,
              band, sub_cost, gap_cost, st);
  } else {
    launch<16>(q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt,
               band, sub_cost, gap_cost, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

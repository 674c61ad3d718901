// General integer-cost banded glocal DP for Hopper: a wavefront of lanes.
//
// Replaces allpathslg_tpu/ops/pallas/banded_pallas.py::banded_align_pallas
// (its _kernel and _min_prefix). Same contract as the plain version
// allpathslg_tpu_torch/ops/banded.py::banded_align: for each problem b,
// align the query q[b, :q_len[b]] glocally into the target t[b, :t_len[b]]
// around the diagonal offset[b] with band half-width `band` (0..255), a
// mismatch costing sub_cost and a gap base gap_cost (0..1024); return the
// least cost and the exclusive target end column reaching it, or (1 << 20,
// -1) when no in-band path exists. Codes are compared as they are: a query
// code 4 matches a target code 4 (unlike csrc/banded_bp.cu). Offsets
// outside [-(Lq + band), Lt + band] are clamped and the problem gets t_len
// = -1, so it reports (1 << 20, -1), as the TPU kernel does. Among equal
// costs the lowest band slot wins.
//
// Recurrence. Slot k in [0, K), K = 2 * band + 1, of row r is target column
// j = r + c + k, c = offset - band. With D[r][K] = BIG,
//   D[r][k] = min(D[r-1][k] + (q[r-1] == t[j-1] ? 0 : sub),   (diag)
//                 D[r-1][k+1] + gap,                           (up)
//                 D[r][k-1] + gap)                             (left)
// for 1 <= j <= t_len; D[r][k] = r * gap where j == 0; BIG where j < 0 or
// j > t_len. Row 0 is 0 where 0 <= j <= t_len. The answer is row
// n_rows = q_len (0 when q_len is outside [1, Lq]), over the slots whose
// end column q_len + c + k lies in [0, t_len].
//
// What the kernel keeps from this, exactly (tests/
// test_torch_banded_general_schedule.py emulates it step by step):
// * Dependencies run from column j-1 or j to column j. So a cell with j >
//   t_len never reaches a cell with j <= t_len, and the kernel lets such
//   cells hold whatever the recurrence gives them: no mask. Cells with j <
//   0 only ever see cells with j < 0, so from a row of BIG they stay >= BIG.
//   The j == 0 cell is r * gap by the `up` term alone, since the row above
//   holds (r-1) * gap one slot to the right. Values are not clamped to BIG
//   in the loop: a cell whose true value is below BIG gets it exactly (its
//   least path never passes BIG), every other cell stays >= BIG, and the
//   final minimum is clamped. Values stay below 2 * BIG + (Lq + K) * 1024,
//   far inside int32 for Lq <= 2**20.
// * When offset + band < 0, the rows before rs = -(offset + band) lie left
//   of column 0 and are all BIG; row rs is BIG except r * gap at slot K-1
//   (column 0 entering the band). The kernel starts from row rs.
// * Slot K (just past the band) must stay BIG, since slot K-1 takes `up`
//   from it: its `left` step adds BIG in place of gap (gp[] below), so no
//   finite value enters it. Slots past K feed nothing below K.
//
// Design: a wavefront. Each problem gets P lanes (a power of two <= 32);
// lane l holds the S contiguous slots l*S .. l*S + S - 1 in registers, S =
// ceil(K / P). At step tau lane l computes row r = rs + 1 + tau - l, so each
// row walks across the lanes one step apart, and a step needs values only
// from the two neighbouring lanes:
//   1. `left` into slot 0 is lane l-1's last slot of the same row, computed
//      the step before: one __shfl_up_sync.
//   2. `up` into the last slot is lane l+1's slot 0 of row r-1, which lane
//      l+1 computes in this same step as min(m0, carry + gap): m0 its
//      up/diagonal minimum from the row above it, carry this lane's last
//      slot of row r-1. So lane l+1 shuffles m0 down at the start of the
//      step (one __shfl_down_sync, off the chain) and this lane finishes
//      the min with its own last slot: no shuffle waits on this step's
//      chain. This needs S >= 2 (or P = 1): with S = 1, lane l+1's m0 would
//      need lane l+2's new slot, and so on across the warp within one step.
//   3. Slot 0, then slots 1..S-1 in order, each one dependent instruction
//      after the last (the horizontal closure).
// The whole DP is (rows - rs) + P - 1 steps of S dependent instructions
// and one shuffle,
// in place of rows x (S-slot prefix + 5-step warp scan) of the earlier
// design (one warp a problem, S a power of two, the closure a scan a row).
// Each cell is 5 instructions (ISETP, SEL, IADD for the diagonal and two
// Hopper DPX __viaddmin_s32 = min(a + b, c) for `up` and `left`), the count
// that chip_smoke.GENERAL_OPS_PER_SLOT carries. Lanes outside [rs + 1,
// n_rows] run the cells too but keep their old values (a select each,
// off the chain), and take part in the shuffles, so a lane ahead of the
// fill still reads the row it needs and lanes past the answer row keep it.
//
// Data in the row loop comes from registers and shuffles, never from
// memory: the query code of a row passes down the wavefront with it (lane l
// uses at step tau the code lane l-1 used at step tau-1); a slot's target
// code at the next row is the code of the slot to its right, so the S codes
// shift by one each step and the last comes from lane l+1's slot 1 (one
// __shfl_down_sync). Only the group's first lane (a query code) and last
// lane (a target code) need a new byte a step; the group loads those P
// steps at a time, one byte a lane, a chunk ahead, and hands each out by
// one __shfl_sync. These three shuffles for the next step are issued
// before the step's chain, so they wait on nothing. So no shared memory
// and no limit on Lq beyond int32.
//
// Launch plan (banded_general_launch): for B <= kLatencyBatch (run_full's
// patch_gaps batches are B = 8) each problem's chain is the whole time, so
// a problem gets the most lanes that still give each lane two slots: P =
// min(32, the largest power of two <= K / 2) (band 192: P = 32, S = 13;
// band 16: P = 16, S = 3; band 1: P = 1, S = 3). For larger B the card is
// full and the work counts: the fewest lanes with S <= kThroughputSlots,
// which cuts dead slots (P * S - K) and fill steps (P - 1) per problem
// (band 96: P = 16, S = 13; band 15: P = 2, S = 16). Groups of one warp
// share it; kBlockWarps warps a block; one launch a call.
//
// Bound. At B = 8 the 8 problems run on 2 SMs, so the time is the chain:
// (rows - rs + P - 1) steps of S DPX latencies plus a shuffle, and the
// launch (chip_smoke.general_bound's chain term: (2 * max q_len + K)
// dependent instructions at the measured DPX latency plus an empty launch).
// The design answers with the wavefront (no warp-wide scan a row, rows
// overlapped across lanes) and non-power-of-two S. At large B the bound is
// the 5 instructions a cell over the card's int32 rate; the design answers
// with the throughput plan (few dead slots and fill steps) and no memory
// traffic in the row loop beyond one chunk load per P steps.
//
// Built by allpathslg_tpu_torch/ops/cuda/nvcc.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (ops/cuda/banded_general_cuda.py) through the
// extern "C" functions at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kMaxBand = 255;
constexpr int kMaxLq = 1 << 20;      // keeps every cell inside int32
constexpr int kBlockWarps = 4;
constexpr int kLatencyBatch = 1024;  // B up to this: the latency plan
constexpr int kThroughputSlots = 16; // the throughput plan's S at most (<= 16)
constexpr unsigned kFull = 0xffffffffu;

template <int S>
__global__ void __launch_bounds__(kBlockWarps * 32)
banded_general_kernel(const uint8_t* __restrict__ q,
                      const uint8_t* __restrict__ t,
                      const int32_t* __restrict__ q_len,
                      const int32_t* __restrict__ t_len,
                      const int32_t* __restrict__ offset,
                      int32_t* __restrict__ cost_out,
                      int32_t* __restrict__ t_end_out, int n_problems, int Lq,
                      int Lt, int band, int sub_cost, int gap_cost, int P,
                      int log2P) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (P - 1);  // lane within the problem's group
  const int warp = blockIdx.x * kBlockWarps + (threadIdx.x >> 5);
  const int b = (warp << (5 - log2P)) + (lane >> log2P);
  const bool real = b < n_problems;
  const int K = 2 * band + 1;
  const int k0 = l * S;  // this lane's first slot

  int ql = 0, tl = -1, off = 0;
  if (real) {
    ql = q_len[b];
    tl = t_len[b];
    off = offset[b];
  }
  const int off_min = -(Lq + band), off_max = Lt + band;
  if (off < off_min || off > off_max) tl = -1;
  off = min(max(off, off_min), off_max);
  const int c = off - band;  // column of slot 0 at row 0
  const int n_rows = (ql >= 1 && ql <= Lq) ? ql : 0;
  const int rs = max(0, -(off + band));  // the first row not all BIG
  const bool live = real && tl >= 0 && n_rows >= rs;
  const int span = live ? n_rows - rs : 0;  // rows to compute
  const int steps = __reduce_max_sync(kFull, span > 0 ? span + P - 1 : 0);
  const uint8_t* qrow = q + static_cast<size_t>(real ? b : 0) * Lq;
  const uint8_t* trow = t + static_cast<size_t>(real ? b : 0) * Lt;

  // row rs, the left-gap of each slot, and the target codes of step 0
  // (t index of slot s at step tau: ib + tau + s, clamped as the plain
  // version's gather clamps it)
  const int ib = rs + c + k0 - l;
  int cur[S], gp[S], tc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = k0 + s;
    const int j = c + k + rs;
    int v = kBig;
    if (rs == 0) {
      if (k < K && j >= 0 && j <= tl) v = 0;
    } else if (k == K - 1) {
      v = static_cast<int>(min(static_cast<long long>(rs) * gap_cost,
                               static_cast<long long>(kBig)));
    }
    cur[s] = v;
    gp[s] = k == K ? kBig : gap_cost;
    tc[s] = real ? trow[min(max(ib + s, 0), Lt - 1)] : 0;
  }
  int qc = (real && l == 0 && rs < Lq) ? qrow[rs] : 0;

  // the bytes the group's edge lanes need at step u, P steps a chunk: lane
  // m holds the query code of step u0 + m (byte 0) and the last lane's new
  // target code of step u0 + m (byte 1)
  const int tail0 = rs + c + (P - 1) * (S - 1) + S - 1;
  auto chunk = [&](int u0) -> uint32_t {
    const int u = u0 + l;
    const uint32_t qv = (real && rs + u < Lq) ? qrow[rs + u] : 0u;
    const uint32_t tv = real ? trow[min(max(tail0 + u, 0), Lt - 1)] : 0u;
    return qv | (tv << 8);
  };
  uint32_t ck_cur = chunk(0), ck_next = chunk(P);

  const int gp_next = k0 + S == K ? kBig : gap_cost;  // lane l+1's gp[0]
  for (int tau = 0; tau < steps; ++tau) {
    const bool active = static_cast<unsigned>(tau - l) <
                        static_cast<unsigned>(span);
    // slot 0's up/diagonal minimum, from the row above alone
    const int up0 = S > 1 ? cur[S > 1 ? 1 : 0] : kBig;  // S == 1: P == 1
    const int m0 = __viaddmin_s32(up0, gap_cost,
                                  cur[0] + (tc[0] == qc ? 0 : sub_cost));
    int carry = __shfl_up_sync(kFull, cur[S - 1], 1, P);
    if (l == 0) carry = kBig;
    // lane l+1's new slot 0, the `up` of this lane's last slot: its m0 and
    // its carry, which is this lane's last slot of the row above (a lane
    // not yet started sends its held value)
    const int m0_next = __shfl_down_sync(kFull, active ? m0 : cur[0], 1, P);
    int up_last = __viaddmin_s32(cur[S - 1], gp_next, m0_next);
    if (l == P - 1) up_last = kBig;
    // the next step's codes, shuffled now so that they arrive while this
    // step's chain runs
    const int u = tau + 1;
    if ((u & (P - 1)) == 0) {
      ck_cur = ck_next;
      ck_next = chunk(u + P);
    }
    const uint32_t edge = __shfl_sync(kFull, ck_cur, u & (P - 1), P);
    const int q_in = __shfl_up_sync(kFull, qc, 1, P);
    const int t_in = __shfl_down_sync(kFull, tc[S > 1 ? 1 : 0], 1, P);
    // every lane runs the chain; a lane outside its rows keeps its values
    // (a select off the chain: a branch around the cells cost ~20 % more
    // at B = 8)
    int nv = __viaddmin_s32(carry, gp[0], m0);
#pragma unroll
    for (int s = 1; s < S; ++s) {
      const int up = s + 1 < S ? cur[s + 1 < S ? s + 1 : s] : up_last;
      const int diag = cur[s] + (tc[s] == qc ? 0 : sub_cost);
      const int v = __viaddmin_s32(nv, gp[s],
                                   __viaddmin_s32(up, gap_cost, diag));
      cur[s - 1] = active ? nv : cur[s - 1];
      nv = v;
    }
    cur[S - 1] = active ? nv : cur[S - 1];
    qc = l == 0 ? static_cast<int>(edge & 0xffu) : q_in;
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) tc[s] = tc[s + 1];
    tc[S - 1] = l == P - 1 ? static_cast<int>(edge >> 8) : t_in;
  }

  // the answer row's least cost over the slots whose end column lies in
  // the target (the plain version's raw q_len), ties to the lowest slot
  const int jb = ql + c;
  int best = kBig, best_k = K;
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s;
      const int jf = jb + k;
      if (k < K && jf >= 0 && jf <= tl && cur[s] < best) {
        best = cur[s];
        best_k = k;
      }
    }
  }
  for (int d = P >> 1; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, d, P);
    const int ok = __shfl_xor_sync(kFull, best_k, d, P);
    if (ov < best || (ov == best && ok < best_k)) {
      best = ov;
      best_k = ok;
    }
  }
  if (real && l == 0) {
    cost_out[b] = best;
    t_end_out[b] = best < kBig ? jb + best_k : -1;
  }
}

// Lanes a problem (see the header's launch plan)
int plan_lanes(int n_problems, int K) {
  int P = 1;
  while (P < 32 && 4 * P <= K) P *= 2;  // the most with S >= 2
  if (n_problems > kLatencyBatch) {
    int fewest = 1;
    while (fewest < P && (K + fewest - 1) / fewest > kThroughputSlots)
      fewest *= 2;
    P = fewest;
  }
  return P;
}

template <int S>
void launch(const uint8_t* q, const uint8_t* t, const int32_t* q_len,
            const int32_t* t_len, const int32_t* offset, int32_t* cost,
            int32_t* t_end, int n_problems, int Lq, int Lt, int band,
            int sub_cost, int gap_cost, int P, cudaStream_t stream) {
  int log2P = 0;
  while ((1 << log2P) < P) ++log2P;
  const int per_block = kBlockWarps * (32 / P);
  const int blocks = (n_problems + per_block - 1) / per_block;
  banded_general_kernel<S><<<blocks, kBlockWarps * 32, 0, stream>>>(
      q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt, band,
      sub_cost, gap_cost, P, log2P);
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
  if (band < 0 || band > kMaxBand || Lq < 0 || Lq > kMaxLq || Lt < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = 2 * band + 1;
  const int P = plan_lanes(n_problems, K);
  const int S = (K + P - 1) / P;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BG_CASE(n)                                                          \
  case n:                                                                   \
    launch<n>(q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt, \
              band, sub_cost, gap_cost, P, st);                             \
    break;
  switch (S) {
    BG_CASE(1) BG_CASE(2) BG_CASE(3) BG_CASE(4) BG_CASE(5) BG_CASE(6)
    BG_CASE(7) BG_CASE(8) BG_CASE(9) BG_CASE(10) BG_CASE(11) BG_CASE(12)
    BG_CASE(13) BG_CASE(14) BG_CASE(15) BG_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BG_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Bit-parallel banded glocal edit distance (unit costs, band <= 15) for
// Hopper.
//
// Replaces allpathslg_tpu/ops/pallas/banded_bp.py::banded_align_bp (its
// _kernel; scripts/profile_banded_e2e.py::kern_only is a timing copy of
// the same kernel). Same contract: for each problem b, align the query
// q[b, :q_len[b]] glocally into the target t[b, :t_len[b]] around the
// diagonal offset[b] with band half-width `band`; return the least edit
// cost and the exclusive target end column reaching it, or (1 << 20, -1)
// when no in-band path exists.
//
// Formulation (Myers 1999 / Hyyro 2003, in the TPU kernel's diagonal-slot
// coordinates): slot k = j - i - off + band, K = 2 * band + 1 <= 31 slots
// in one uint32. A row is delta-encoded: bit k of P / M says that
// v[k] - v[k-1] is +1 / -1, and s0 = v[0]. Row i - 1 -> i:
//   Eq[k] = (q[i-1] == t[j-1])     j = i + off - band + k
//   X  = Eq | (M >> 1)
//   c  = carries of X + (X | P)
//   Z  = X | (P & c)
//   P' = (P & ~(c ^ Z)) | (~(P | M) & c & ~Z)
//   M' = (M & ~(c ^ Z)) | (~(P | M) & ~c & Z)
//   s0 += 1 - (Z & 1)
// The target is treated as extended on both sides with codes that never
// match, so the left-extension cells equal i (the j = 0 deletion column)
// and row 0 is all zero (P = M = s0 = 0). A query code >= 4 matches
// nothing, nor does a target code >= 4. Offsets outside [-(Lq + band),
// Lt + band] are clamped and the problem gets t_len = -1, so it reports
// (1 << 20, -1). The answer is the row q_len (row 0 when q_len is 0, and
// also when q_len < 0 or q_len > Lq rounded up to 32, as the TPU kernel's
// capture does); a final scan over k = 0..K-1 keeps the strictly smaller
// cost, so ties go to the lowest slot. Eq reads target columns up to Lt,
// not t_len; query rows past Lq read as code 4.
//
// What bounds it: run_full gives it 65,536 problems of 260 x 276
// (align_frags, polish; ~132 rows a problem) and of 100 x 116
// (align_jumps; ~84 rows), band 8. A row is the recurrence above, 12
// instructions (run_rows), on one serial chain per problem; at the card's
// int32 rate the rows outlast the bytes the batch needs at align_frags
// and fall just short of them at align_jumps, and a batch holds only
// ~15.5 warps of chains an SM to hide each chain's latency. The design
// keeps everything but the recurrence off the chain and small:
// - One thread owns one problem, rows in chunks of 32. Bit-parallel
//   planes of the target (bit x of plane c: column j0 + x is code c, j0 =
//   off - band) are built once per 32 columns, and each row's Eq is one
//   funnel shift of two plane words: Eq = funnelshift_r(lo, hi, i) for row
//   32 m + i + 1 of chunk m, where lo and hi are words m and m + 1 of the
//   plane the row's query code names. The four planes' current word pairs
//   live in shared memory as uint2 [5][kThreads] (plane 4 is zero: any
//   code >= 4), so a row picks its plane with one conflict-free 8-byte
//   load and no select; columns outside [0, Lt) are 0 in every plane.
// - A plane word is built from 32 target bytes with byte-parallel bit
//   tricks (bit 0, bit 1 and "code >= 4" of four bytes at once, each
//   gathered into a nibble by one multiply), and the four planes from
//   those three 32 columns at a time, in place of the old per-row slide
//   (16 operations and a 4-way select a row).
// - Loads leave the row loop: the next chunk's 32 query bytes and the
//   target's next 32 columns are loaded at the start of a chunk, as
//   4-byte aligned words (any row stride and offset; a byte path with
//   bounds only where the 32 bytes cross a row's edge), and used one
//   chunk later, so their latency hides behind 32 rows. Shared-memory
//   staging of whole rows would take ~68 KB a 128-problem block and leave
//   fewer warps resident than a full batch gives each SM.
// - The recurrence is regrouped for three-input logic ops (run_rows), and
//   s0's steps are counted once a chunk with a popcount. A warp's loop
//   count is uniform: chunks every lane fills run with no guard, the
//   warp's last chunks with a per-row select, stopping after the group of
//   kAhead rows that holds the warp's last row. Lanes whose queries end
//   early idle: ~9 % (align_frags) and ~15 % (align_jumps) of lane-rows
//   at run_full's batches (scripts/tune_banded_bp.py prints it), below
//   the ~20 % at which reordering problems by length would pay.
// What remains (scripts/tune_banded_bp.py's row split and experiments):
// the chunk loads and plane builds take about a third of a row's time,
// and a launch has a fixed ~5 us (prologue, final scan, launch).
// ptxas (-Xptxas -v, sm_90a): 122 registers, 5,120 bytes of shared memory
// a block of 128 threads, no spills; kMinBlocks lets it use more than 64
// registers, which it otherwise keeps to.
//
// Built by allpathslg_tpu_torch/ops/cuda/nvcc.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (ops/cuda/banded_cuda.py) through the extern "C"
// functions at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kThreads = 128;          // problems per block, one a thread
constexpr int kAhead = 8;              // rows whose Eq words load together
constexpr int kMinBlocks = 4;          // __launch_bounds__: blocks an SM
constexpr uint32_t kFill = 0x04040404u;  // bytes outside a row: code 4

// The 32 bytes [start, start + 32) of a row: the nine 4-byte aligned
// words that cover them and the byte shift of `start` in the first.
// (16-byte vector loads timed the same and need a select per word to
// realign: a warp's lanes read 32 different rows either way.)
struct Raw {
  uint32_t w[9];
  uint32_t sh;
};

// Bytes of the row (`len` bytes) outside [0, len) read as code 4. Only
// words that hold a byte of the row are read.
__device__ __forceinline__ void load_raw(const uint8_t* row, int start,
                                         int len, Raw& r) {
  const intptr_t a = reinterpret_cast<intptr_t>(row) + start;
  const intptr_t ab = a & ~static_cast<intptr_t>(3);
  r.sh = static_cast<uint32_t>(a - ab);
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(ab);
  if (start >= 0 && start + 32 <= len) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = __ldg(wp + i);
    r.w[8] = r.sh ? __ldg(wp + 8) : 0u;
    return;
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int c0 = start - static_cast<int>(r.sh) + 4 * i;
    if (c0 >= 0 && c0 + 4 <= len) {
      r.w[i] = __ldg(wp + i);
    } else if (c0 >= len || c0 + 4 <= 0) {
      r.w[i] = kFill;
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + k;
        const uint32_t byte = (c >= 0 && c < len) ? row[c] : 4u;
        w |= byte << (8 * k);
      }
      r.w[i] = w;
    }
  }
}

// The 32 bytes of a Raw in order: byte 4 i + k of the span is byte k of
// v[i].
__device__ __forceinline__ void realign(const Raw& r, uint32_t (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = __funnelshift_r(r.w[i], r.w[i + 1], 8 * r.sh);
}

// Bit 7 + 8 k of x -> bit 28 + k, k = 0..3 (the other bits of x are
// cleared first): the 16 partial products land on distinct bits (28..31,
// six below, the rest past bit 31), so nothing carries into the result.
__device__ __forceinline__ uint32_t gather_hi(uint32_t x) {
  return (x & 0x80808080u) * 0x00204081u;
}

// Plane words of 32 target columns: bit x of e[c] says column x is code
// c. Per 4 columns (one word v[i]), three byte-parallel tests put their
// bits at 7 + 8 k: bit 0 of the code, bit 1, and "code >= 4"; one
// multiply gathers each into a nibble. The planes are then combined 32
// columns at once.
__device__ __forceinline__ void build_planes(const uint32_t (&v)[8],
                                             uint32_t (&e)[4]) {
  uint32_t lo = 0, hi = 0, big = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = v[i];
    const uint32_t keep = 0xF0000000u >> (28 - 4 * i);
    lo |= (gather_hi(x << 7) >> (28 - 4 * i)) & keep;
    hi |= (gather_hi(x << 6) >> (28 - 4 * i)) & keep;
    // bit 7 of each byte: bits 2..7 of the byte are not all zero
    const uint32_t b = ((x & 0x7C7C7C7Cu) + 0x7C7C7C7Cu) | x;
    big |= (gather_hi(b) >> (28 - 4 * i)) & keep;
  }
  e[0] = ~(lo | hi | big);
  e[1] = lo & ~(hi | big);
  e[2] = hi & ~(lo | big);
  e[3] = lo & hi & ~big;
}

struct State {
  uint32_t P, M;
  int s0;
  uint32_t hi[4];  // word m + 1 of each plane during chunk m
  Raw nq, nt;      // the next chunk's query bytes and plane columns
};

// Rows g .. g + kAhead - 1 of a chunk, their Eq words in eq: the header's
// recurrence, grouped for three-input logic ops (LOP3) as P' = P ? ~d :
// d & tP and M' = M ? ~d : d & tM, with d = c ^ Z, tP = c & ~M & bandmask
// and tM = ~c & ~P & bandmask (c & ~Z is d & c, Z & ~c is d & ~c): 12
// instructions a row with bit 0 of Z, and tP, tM off the serial chain.
// Bit 0 of each row's Z goes into zb, whose bits are counted once a
// chunk. With kSel, a row changes P and M only when it is one of the
// lane's rows (g + u < rem).
template <bool kSel>
__device__ __forceinline__ void run_rows(const uint32_t (&eq)[kAhead],
                                         uint32_t& P, uint32_t& M,
                                         uint32_t& zb, int g, int rem,
                                         uint32_t bandmask) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const uint32_t x = eq[u] | (M >> 1);
    const uint32_t v = x | P;
    const uint32_t c = ((x + v) ^ x) ^ v;
    const uint32_t z = x | (P & c);
    const uint32_t d = c ^ z;
    const uint32_t tP = c & ~M & bandmask;
    const uint32_t tM = ~c & ~P & bandmask;
    const uint32_t P2 = (P & ~d) | (~P & d & tP);
    const uint32_t M2 = (M & ~d) | (~M & d & tM);
    zb = __funnelshift_r(zb, z, 1);
    const bool on = !kSel || g + u < rem;
    P = on ? P2 : P;
    M = on ? M2 : M;
  }
}

// One chunk m of 32 rows. With kGuard (the warp's last chunks), a lane's
// rows past its query take no effect (a select, not a branch: one more
// split into unguarded groups timed slower) and the warp stops after the
// group of kAhead rows that holds its last row. The Eq words of a group
// are fetched before its recurrence runs.
template <bool kGuard>
__device__ __forceinline__ void run_chunk(State& st, uint2 (*pl)[kThreads],
                                          int tid, int m, int n_rows,
                                          const uint8_t* qrow,
                                          const uint8_t* trow, int Lq,
                                          int Lt, int j0,
                                          uint32_t bandmask) {
  uint32_t qw[8];
  realign(st.nq, qw);
  const bool more = 32 * (m + 1) < n_rows;
  if (more) {
    load_raw(qrow, 32 * (m + 1), Lq, st.nq);
    load_raw(trow, j0 + 32 * (m + 2), Lt, st.nt);
  }
  const int rem = n_rows - 32 * m;
  const int rem_max = kGuard ? __reduce_max_sync(0xFFFFFFFFu, rem) : 32;
  const uint2* mine = &pl[0][tid];
  uint32_t P = st.P, M = st.M;
  uint32_t zb = 0;  // bit 0 of each row's Z (the slot-0 cell's step)
#pragma unroll
  for (int g = 0; g < 32; g += kAhead) {
    if (g >= rem_max) break;
    uint32_t eq[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = g + u;
      const uint32_t code = __byte_perm(qw[i >> 2], 0u, 0x4440u | (i & 3));
      const uint2 w = mine[min(code, 4u) * kThreads];
      eq[u] = __funnelshift_r(w.x, w.y, i);
    }
    run_rows<kGuard>(eq, P, M, zb, g, rem, bandmask);
  }
  // s0 += 1 - (Z & 1) for each row that ran; after n steps row i's bit
  // is bit 32 - n + i of zb (n >= 1: the warp's last chunk has a row)
  const int n = min(32, (rem_max + kAhead - 1) / kAhead * kAhead);
  const uint32_t ran = rem >= 32 ? 0xFFFFFFFFu
                       : rem > 0 ? (1u << rem) - 1u : 0u;
  st.s0 += __popc(~zb & (ran << (32 - n)));
  st.P = P;
  st.M = M;
  if (more) {
    uint32_t tv[8], e[4];
    realign(st.nt, tv);
    build_planes(tv, e);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pl[c][tid] = make_uint2(st.hi[c], e[c]);
      st.hi[c] = e[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
banded_bp_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int32_t* __restrict__ q_len,
                 const int32_t* __restrict__ t_len,
                 const int32_t* __restrict__ offset,
                 int32_t* __restrict__ cost_out,
                 int32_t* __restrict__ t_end_out,
                 int n_problems, int Lq, int Lt, int band) {
  __shared__ uint2 pl[5][kThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  const bool live = b < n_problems;  // no early return: warp reductions
  const int K = 2 * band + 1;
  const uint32_t bandmask = ((1u << K) - 1u) & ~1u;

  int ql = 0, tl = -1, off = 0;
  if (live) {
    ql = q_len[b];
    tl = t_len[b];
    off = offset[b];
  }
  // feasible-offset clamp: an infeasible problem keeps no end column
  const int off_min = -(Lq + band), off_max = Lt + band;
  if (off < off_min || off > off_max) tl = -1;
  off = min(max(off, off_min), off_max);
  const int lq_pad = (Lq + 31) / 32 * 32;
  const int n_rows = (live && ql >= 1 && ql <= lq_pad) ? ql : 0;
  const uint8_t* qrow = q + static_cast<size_t>(live ? b : 0) * Lq;
  const uint8_t* trow = t + static_cast<size_t>(live ? b : 0) * Lt;
  const int j0 = off - band;  // target column of slot 0 in row 1

  State st;
  st.P = st.M = 0;
  st.s0 = 0;
  pl[4][tid] = make_uint2(0u, 0u);
  if (n_rows > 0) {
    uint32_t tv[8], e0[4];
    load_raw(trow, j0, Lt, st.nt);
    realign(st.nt, tv);
    build_planes(tv, e0);
    load_raw(trow, j0 + 32, Lt, st.nt);
    realign(st.nt, tv);
    build_planes(tv, st.hi);
#pragma unroll
    for (int c = 0; c < 4; ++c) pl[c][tid] = make_uint2(e0[c], st.hi[c]);
    load_raw(qrow, 0, Lq, st.nq);
  }
  const int n_full = __reduce_min_sync(0xFFFFFFFFu, n_rows / 32);
  const int n_chunks = __reduce_max_sync(0xFFFFFFFFu, (n_rows + 31) / 32);
  for (int m = 0; m < n_full; ++m)
    run_chunk<false>(st, pl, tid, m, n_rows, qrow, trow, Lq, Lt, j0,
                     bandmask);
  for (int m = n_full; m < n_chunks; ++m)
    run_chunk<true>(st, pl, tid, m, n_rows, qrow, trow, Lq, Lt, j0,
                    bandmask);
  if (!live) return;

  // final scan over the band: strictly smaller wins, ties to the lowest k
  const int jbase = ql + off - band;
  int best = kBig, best_end = -1;
  int val = st.s0;
  for (int k = 0; k < K; ++k) {
    if (k > 0) {
      val += static_cast<int>((st.P >> k) & 1u) -
             static_cast<int>((st.M >> k) & 1u);
    }
    const int jf = jbase + k;
    const int cand = (jf >= 0 && jf <= tl) ? val : kBig;
    if (cand < best) {
      best = cand;
      best_end = jf;
    }
  }
  cost_out[b] = best;
  t_end_out[b] = best < kBig ? best_end : -1;
}

}  // namespace

extern "C" {

const char* banded_bp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch over n_problems problems on `stream`; q is uint8 [B, Lq] and
// t uint8 [B, Lt], row-major and contiguous; q_len, t_len, offset, cost and
// t_end int32 [B]. Returns the launch's cudaError_t (0 on success).
int banded_bp_launch(const uint8_t* q, const uint8_t* t, const int32_t* q_len,
                     const int32_t* t_len, const int32_t* offset,
                     int32_t* cost, int32_t* t_end, int n_problems, int Lq,
                     int Lt, int band, void* stream) {
  if (n_problems <= 0) return 0;
  if (band < 0 || band > 15) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_problems + kThreads - 1) / kThreads;
  banded_bp_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      q, t, q_len, t_len, offset, cost, t_end, n_problems, Lq, Lt, band);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

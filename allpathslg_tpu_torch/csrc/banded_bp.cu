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
// nothing. Offsets outside [-(Lq + band), Lt + band] are clamped and the
// problem gets t_len = -1, so it reports (1 << 20, -1). The answer is the
// row q_len (row 0 when q_len is 0, and also when q_len < 0 or q_len >
// Lq rounded up to 32, as the TPU kernel's capture does); a final scan
// over k = 0..K-1 keeps the strictly smaller cost, so ties go to the
// lowest slot.
//
// Bound: neither bytes nor operations at the align_frags rescue shape
// (65,536 problems of 260 x 276): a row costs one query byte, one target
// byte and ~25 integer operations per problem, ~1.3 GB and ~0.5 G
// operations per call. The TPU kernel's [8, 128] tiles, its bit-plane
// packing of the whole target and its word rolls exist for the TPU's
// vector unit; here one thread owns one problem, keeps P, M, s0 and a
// 4-plane window of the K in-band target columns (Eq per base code) in
// registers, and slides that window one column per row: shift each plane
// right by one and set bit K-1 of the new column's code. Each thread reads
// its own query and target rows in order, so its cache lines are reused
// for 128 rows. Coalesced [L, B] layouts and several problems per warp
// are left for later work.
//
// Built by allpathslg_tpu_torch/ops/cuda/nvcc.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (ops/cuda/banded_cuda.py) through the extern "C"
// functions at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t plane_bit(uint32_t code, uint32_t c,
                                              int bit) {
  return static_cast<uint32_t>(code == c) << bit;
}

__global__ void __launch_bounds__(kThreads)
banded_bp_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int32_t* __restrict__ q_len,
                 const int32_t* __restrict__ t_len,
                 const int32_t* __restrict__ offset,
                 int32_t* __restrict__ cost_out,
                 int32_t* __restrict__ t_end_out,
                 int n_problems, int Lq, int Lt, int band) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_problems) return;
  const int K = 2 * band + 1;
  const uint32_t kmask = (1u << K) - 1u;
  const uint32_t bandmask = kmask & ~1u;
  const uint8_t* qrow = q + static_cast<size_t>(b) * Lq;
  const uint8_t* trow = t + static_cast<size_t>(b) * Lt;

  const int ql = q_len[b];
  int tl = t_len[b];
  int off = offset[b];
  // feasible-offset clamp: an infeasible problem keeps no end column
  const int off_min = -(Lq + band), off_max = Lt + band;
  if (off < off_min || off > off_max) tl = -1;
  off = min(max(off, off_min), off_max);
  const int lq_pad = (Lq + 31) / 32 * 32;
  const int n_rows = (ql >= 1 && ql <= lq_pad) ? ql : 0;

  // Eq planes for row 1 minus its last slot: bit k + 1 holds the column
  // of slot k of row 1, so the first shift puts it at bit k
  uint32_t e0 = 0, e1 = 0, e2 = 0, e3 = 0;
  const int j0 = off - band;  // target index of slot 0 in row 1
  for (int k = 0; k < K - 1; ++k) {
    const int tj = j0 + k;
    if (tj >= 0 && tj < Lt) {
      const uint32_t code = trow[tj];
      e0 |= plane_bit(code, 0, k + 1);
      e1 |= plane_bit(code, 1, k + 1);
      e2 |= plane_bit(code, 2, k + 1);
      e3 |= plane_bit(code, 3, k + 1);
    }
  }

  uint32_t P = 0, M = 0;
  int s0 = 0;
  for (int r = 1; r <= n_rows; ++r) {
    // slide the window one column: slot K - 1 takes target index
    // r - 1 + off - band + K - 1
    e0 >>= 1;
    e1 >>= 1;
    e2 >>= 1;
    e3 >>= 1;
    const int tj = r + j0 + K - 2;
    if (tj >= 0 && tj < Lt) {
      const uint32_t code = trow[tj];
      e0 |= plane_bit(code, 0, K - 1);
      e1 |= plane_bit(code, 1, K - 1);
      e2 |= plane_bit(code, 2, K - 1);
      e3 |= plane_bit(code, 3, K - 1);
    }
    const uint32_t qc = r <= Lq ? qrow[r - 1] : 4u;
    uint32_t eq = qc == 0 ? e0 : qc == 1 ? e1 : qc == 2 ? e2 : e3;
    if (qc >= 4) eq = 0;
    eq &= kmask;

    const uint32_t x = eq | (M >> 1);
    const uint32_t v = x | P;
    const uint32_t c = ((x + v) ^ x) ^ v;
    const uint32_t z = x | (P & c);
    const uint32_t ncz = ~(c ^ z);
    const uint32_t pm = ~(P | M);
    const uint32_t P2 = ((P & ncz) | (pm & c & ~z)) & bandmask;
    const uint32_t M2 = ((M & ncz) | (pm & ~c & z)) & bandmask;
    s0 += 1 - static_cast<int>(z & 1u);
    P = P2;
    M = M2;
  }

  // final scan over the band: strictly smaller wins, ties to the lowest k
  const int jbase = ql + off - band;
  int best = kBig, best_end = -1;
  int val = s0;
  for (int k = 0; k < K; ++k) {
    if (k > 0) {
      val += static_cast<int>((P >> k) & 1u) - static_cast<int>((M >> k) & 1u);
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

"""Batched banded affine-gap alignment DP, cost only (port of
allpathslg_tpu/ops/affine.py).

Behavior contract (ref: src/pairwise_aligners/SmithWatAffine.{h,cc} --
SURVEY.md §2.2): align query q against target t around diagonal `offset`
with band half-width W under affine gap costs (mismatch `sub_cost`, gap
open `gap_open` charged once per gap run plus `gap_ext` per base). Glocal
semantics match ops/banded.py: the whole query aligns into a free target
window (D[0][j] = 0, answer = min_j D[|q|][j]).

Band slot scheme is shared with ops/banded.py: in-band slot k of query row
r maps to target column j = r + offset - W + k, so the diagonal predecessor
stays in the same slot, the vertical one in slot k+1, and the horizontal
one in slot k-1 (same row). Affine state split:

  A[k]  = best cost at (r, j) arriving diagonally or vertically
  Ix[k] = best cost at (r, j) inside a vertical (target-gap) run
  Iy[k] = best cost at (r, j) inside a horizontal (query-gap) run

Iy's within-row recurrence collapses with the min-plus prefix trick:
  Iy[k] = gap_open + k*gap_ext + cummin_{k'<k}(A[k'] - k'*gap_ext).

The reference runs the rows as a `lax.scan`, an XLA program with no Pallas
kernel; here they are a Python loop of torch ops on the inputs' device.
The arithmetic is the reference's, in int32: only the carried row and Iy
are clamped to BIG, so an unreachable cell carries BIG + sub and the Ix
carry grows by gap_ext a row, as there. `np_affine_oracle` is a copy.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 20


def affine_banded_align(q: torch.Tensor, q_len: torch.Tensor,
                        t: torch.Tensor, t_len: torch.Tensor,
                        offset: torch.Tensor, band: int = 16,
                        sub_cost: int = 3, gap_open: int = 4,
                        gap_ext: int = 1):
    """Batched banded glocal affine alignment on the inputs' device.

    Args:
      q: uint8 [B, Lq] query codes (4 = pad beyond q_len).
      t: uint8 [B, Lt] target codes.
      q_len, t_len: int32 [B].
      offset: int32 [B] expected diagonal (query i ~ target i + offset).

    Returns (cost [B] int32, t_end [B] int32): minimal affine alignment
    cost and the (exclusive) target end column attaining it; (BIG, -1)
    when no in-band path exists.
    """
    i32 = torch.int32
    dev = q.device
    B, Lq = q.shape
    Lt = t.shape[1]
    K = 2 * band + 1
    ks = torch.arange(K, dtype=i32, device=dev)[None, :]
    gk = ks * gap_ext
    offs = offset.to(i32)[:, None]
    tl = t_len.to(i32)[:, None]
    ql = q_len.to(i32)[:, None]
    tt = t.to(torch.int64)
    big = torch.tensor(BIG, dtype=i32, device=dev)
    big_col = torch.full((B, 1), BIG, dtype=i32, device=dev)

    # row 0: free target prefix. A = 0 on valid columns; no vertical run yet.
    j0 = offs - band + ks
    a_prev = torch.where((j0 >= 0) & (j0 <= tl), 0, big)
    ix_prev = torch.full((B, K), BIG, dtype=i32, device=dev)
    result = a_prev
    for i in range(Lq):
        r = i + 1
        j = r + offs - band + ks
        in_t = (j >= 1) & (j <= tl)
        jc = torch.clamp(j - 1, 0, Lt - 1).to(torch.int64)
        tb = torch.gather(tt, 1, jc)
        qb = q[:, i:i + 1].to(torch.int64)
        sub = torch.where(tb == qb, 0, sub_cost).to(i32)

        m_prev = torch.minimum(a_prev, ix_prev)        # any-state prev row
        diag = m_prev + sub                            # slot k
        up_m = torch.cat([m_prev[:, 1:], big_col], 1)
        up_ix = torch.cat([ix_prev[:, 1:], big_col], 1)
        ix = torch.minimum(up_m + (gap_open + gap_ext), up_ix + gap_ext)
        a = torch.minimum(diag, ix)
        a = torch.where(in_t, a, big)
        # column 0 (empty target prefix consumed): pure vertical run
        col0 = gap_open + r * gap_ext
        at0 = j == 0
        a = torch.where(at0, col0, a)
        ix = torch.where(at0, col0, torch.where(in_t, ix, big))
        # horizontal closure (min-plus prefix over the row)
        run = torch.cummin(a - gk, dim=1).values
        run = torch.cat([big_col, run[:, :-1]], 1)
        iy = torch.minimum(run + gk + gap_open, big)
        row = torch.minimum(a, iy)
        live = in_t | at0
        row = torch.where(live, row, big)
        result = torch.where(ql == r, row, result)
        # carry A as the any-state row (Iy can be followed by diag/vertical)
        a_prev = torch.minimum(row, big)
        ix_prev = torch.where(live, ix, big)

    jf = ql + offs - band + ks
    ok = (jf >= 0) & (jf <= tl)
    vals = torch.where(ok, result, big)
    cost = vals.min(dim=1).values
    kbest = torch.argmin(vals, dim=1).to(i32)
    t_end = q_len.to(i32) + offset.to(i32) - band + kbest
    t_end = torch.where(cost < BIG, t_end, -1).to(i32)
    return cost, t_end


def np_affine_oracle(q, t, offset, band, sub_cost=3, gap_open=4, gap_ext=1):
    """Unbanded-with-mask numpy oracle (full 3-state affine DP), glocal."""
    Lq, Lt = len(q), len(t)
    INF = 1 << 20
    A = np.full((Lq + 1, Lt + 1), INF, np.int64)    # diag/vertical arrival
    IX = np.full((Lq + 1, Lt + 1), INF, np.int64)   # in vertical run
    IY = np.full((Lq + 1, Lt + 1), INF, np.int64)   # in horizontal run
    for j in range(Lt + 1):
        if abs(j - offset) <= band:
            A[0, j] = 0
    for i in range(1, Lq + 1):
        for j in range(0, Lt + 1):
            if abs(j - i - offset) > band:
                continue
            if j == 0:
                A[i, 0] = IX[i, 0] = gap_open + i * gap_ext
                continue
            prev_any = min(A[i - 1, j], IX[i - 1, j], IY[i - 1, j])
            if prev_any < INF:
                IX[i, j] = min(prev_any + gap_open + gap_ext,
                               IX[i - 1, j] + gap_ext)
            d = min(A[i - 1, j - 1], IX[i - 1, j - 1], IY[i - 1, j - 1])
            if d < INF:
                A[i, j] = d + (0 if q[i - 1] == t[j - 1] else sub_cost)
            A[i, j] = min(A[i, j], IX[i, j])
            left_any = min(A[i, j - 1], IY[i, j - 1])
            if A[i, j - 1] < INF or IY[i, j - 1] < INF:
                IY[i, j] = min(A[i, j - 1] + gap_open + gap_ext,
                               IY[i, j - 1] + gap_ext)
    last = np.minimum(np.minimum(A[Lq], IX[Lq]), IY[Lq])
    cost = int(last.min())
    if cost >= INF:
        return cost, -1
    return cost, int(last.argmin())

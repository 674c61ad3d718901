"""Batched banded alignment DP (port of allpathslg_tpu/ops/banded.py).

Behavior contract (ref: src/pairwise_aligners/SmithWatBandedA.{h,cc}):
align query q against target t around a given diagonal offset with band
half-width W; return the minimal edit-style cost and the target end
position. Glocal semantics (the whole query aligns into a free target
window): D[0][j] = 0, answer = min_j D[|q|][j].

`banded_align` is the plain version, the reference's row recurrence: in-band
slot k in [0, 2W] of row r maps to target column j = r + off - W + k, so
the diagonal predecessor stays in the same slot and the vertical one is
slot k+1; the horizontal dependency is one min-plus prefix,
  D_r[k] = min(M_r[k], k*gap + cummin_{k'<=k}(M_r[k'] - k'*gap)),
taken with `torch.cummin` over the band. It loops over query rows in
Python. It compares query and target codes as they are, so a query code 4
matches a target code 4, as the reference's `banded_align` does.

`banded_align_auto` is the product dispatcher: a CPU tensor takes
`banded_align`; a CUDA tensor at unit costs and band <= 15 takes the Hopper
bit-parallel kernel (ops/cuda/banded_cuda.py, the port of
ops/pallas/banded_bp.py); anything else on a CUDA tensor takes the Hopper
general kernel (ops/cuda/banded_general_cuda.py, the port of
ops/pallas/banded_pallas.py::banded_align_pallas), whose wrapper raises
ValueError above its largest band. The reference's TPU VMEM model
(`banded_bp.vmem_fits`) and its 128-lane batch padding have no
counterpart: the Hopper kernels take any shape.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 20


def banded_align(q, q_len, t, t_len, offset, band: int = 16,
                 sub_cost: int = 1, gap_cost: int = 1):
    """Batched banded glocal alignment.

    Args:
      q: integer [B, Lq] query codes (4 = pad beyond q_len).
      t: uint8 [B, Lt] target codes.
      offset: integer [B] expected diagonal (query i ~ target i + offset).

    Returns (cost [B] int32, t_end [B] int32): minimal alignment cost and
    the (exclusive) target end column attaining it; (BIG, -1) if no in-band
    path exists.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    K = 2 * band + 1
    ks = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    gk = (ks * gap_cost).int()
    offs = offset.long()[:, None]
    tl = t_len.long()[:, None]
    ql = q_len.long()[:, None]
    tt = t.long()
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)

    # D row 0 (empty query prefix): free target prefix -> 0 on valid columns
    j0 = offs - band + ks
    row = torch.where((j0 >= 0) & (j0 <= tl), 0, big)
    result = row                              # answer row for q_len == 0
    pad_col = big.expand(B, 1)
    for i in range(Lq):
        r = i + 1                             # computing D row r
        j = r + offs - band + ks
        in_t = (j >= 1) & (j <= tl)
        jc = (j - 1).clamp(0, Lt - 1)
        tb = torch.gather(tt, 1, jc)
        qb = q[:, i:i + 1].long()
        sub = torch.where(tb == qb, 0, sub_cost).int()

        diag = row + sub                                        # slot k
        up = torch.cat([row[:, 1:], pad_col], 1) + gap_cost
        m = torch.minimum(diag, up)
        m = torch.where(in_t, m, big)
        m = torch.where(j == 0, r * gap_cost, m)                # column 0
        # horizontal closure
        run = torch.cummin(m - gk, dim=1).values
        new = torch.minimum(m, run + gk)
        new = torch.where(in_t | (j == 0), new, big)
        row = torch.minimum(new, big)
        result = torch.where(ql == r, row, result)

    jf = ql + offs - band + ks
    ok = (jf >= 0) & (jf <= tl)
    vals = torch.where(ok, result, big)
    cost = vals.min(dim=1).values
    kbest = torch.argmin(vals, dim=1)         # first index wins, as jnp
    t_end = q_len.long() + offset.long() - band + kbest
    t_end = torch.where(cost < BIG, t_end, -1)
    return cost.to(torch.int32), t_end.to(torch.int32)


def banded_align_auto(q, q_len, t, t_len, offset, band: int = 16,
                      sub_cost: int = 1, gap_cost: int = 1):
    """Product-path dispatcher (see the module docstring)."""
    if q.device.type == "cpu":
        return banded_align(q, q_len, t, t_len, offset, band=band,
                            sub_cost=sub_cost, gap_cost=gap_cost)
    from allpathslg_tpu_torch.ops.cuda import banded_cuda, banded_general_cuda

    if sub_cost == 1 and gap_cost == 1 and band <= banded_cuda.MAX_BAND:
        return banded_cuda.banded_align_bp(q, q_len, t, t_len, offset,
                                           band=band)
    return banded_general_cuda.banded_align_general(
        q, q_len, t, t_len, offset, band=band, sub_cost=sub_cost,
        gap_cost=gap_cost)


def banded_align_host(q, q_len, t, t_len, offset, band: int, device,
                      sub_cost: int = 1, gap_cost: int = 1):
    """banded_align_auto on host arrays: uploads the batch to `device` and
    returns (cost, t_end) as numpy int32 [B]."""
    args = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (q, q_len, t, t_len, offset))
    cost, t_end = banded_align_auto(*args, band=band, sub_cost=sub_cost,
                                    gap_cost=gap_cost)
    return cost.cpu().numpy(), t_end.cpu().numpy()


def np_banded_oracle(q, t, offset, band, sub_cost=1, gap_cost=1):
    """Unbanded-with-mask python oracle for tests (same semantics)."""
    Lq, Lt = len(q), len(t)
    INF = 1 << 20
    D = np.full((Lq + 1, Lt + 1), INF, dtype=np.int64)
    for j in range(Lt + 1):
        if abs(j - 0 - offset) <= band:
            D[0, j] = 0
    for i in range(1, Lq + 1):
        for j in range(0, Lt + 1):
            if abs(j - i - offset) > band:
                continue
            best = INF
            if j == 0:
                best = i * gap_cost
            if j >= 1 and D[i - 1, j - 1] < INF:
                best = min(best, D[i - 1, j - 1] +
                           (0 if q[i - 1] == t[j - 1] else sub_cost))
            if D[i - 1, j] < INF:
                best = min(best, D[i - 1, j] + gap_cost)
            if j >= 1 and D[i, j - 1] < INF:
                best = min(best, D[i, j - 1] + gap_cost)
            D[i, j] = best
    cost = int(D[Lq].min())
    t_end = int(D[Lq].argmin())
    if cost >= INF:
        return cost, -1
    return cost, t_end

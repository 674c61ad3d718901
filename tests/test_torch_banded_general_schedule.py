"""The general banded DP kernel's step schedule, emulated, == the plain version.

`emulate` walks csrc/banded_general.cu's wavefront in plain torch: the
same lanes a problem (P), slots a lane (S), steps, initial row rs, left-gap
of the slot past the band, chunked edge bytes and target-code rotation,
with each shuffle written as an index shift across the lanes and the
kernel's order inside a step (slot 0's up/diagonal minimum shuffled down,
carry in, slot 0, slots 1..S-1, next step's codes). It must equal `banded_general_plain` exactly (cost and
t_end) at bands 0, 1, 15, 16, 96, 192 and 255 under both of the kernel's
launch plans (`plan_lanes`, the kernel's own rule), with costs (1, 1) and
(2, 3), ragged lengths, q_len 0 and q_len = Lq, a target shorter than the
band and offsets at both edges of the feasible window and past them. A
schedule with one slot a lane on many lanes (the hazard of the header) must
differ. Nothing on the main path uses the emulation; the kernel itself is
held against the plain version on a card (tests/test_torch_banded_general.py
and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from allpathslg_tpu_torch.ops.cuda import banded_general_cuda as bg

BIG = 1 << 20


def plan_lanes(n_problems, K, latency_batch=1024, throughput_slots=16):
    """Lanes a problem, as banded_general_launch plans them."""
    P = 1
    while P < 32 and 4 * P <= K:
        P *= 2
    if n_problems > latency_batch:
        fewest = 1
        while fewest < P and -(-K // fewest) > throughput_slots:
            fewest *= 2
        P = fewest
    return P


def _up(x):
    """__shfl_up_sync(x, 1) within each group: lane l gets lane l-1's x
    (lane 0 its own)."""
    return torch.cat([x[:, :1], x[:, :-1]], 1)


def _down(x):
    """__shfl_down_sync(x, 1): lane l gets lane l+1's x (the last its own)."""
    return torch.cat([x[:, 1:], x[:, -1:]], 1)


def emulate(q, q_len, t, t_len, offset, band, sub_cost, gap_cost, P):
    """(cost int32 [B], t_end int32 [B]) by the kernel's schedule."""
    q, t = q.long(), t.long()
    B, Lq = q.shape
    Lt = t.shape[1]
    K = 2 * band + 1
    S = -(-K // P)
    lanes = torch.arange(P)[None, :]
    k0 = lanes * S
    ql, tl, off = q_len.long(), t_len.long().clone(), offset.long()
    off_min, off_max = -(Lq + band), Lt + band
    tl[(off < off_min) | (off > off_max)] = -1
    off = off.clamp(off_min, off_max)
    c = off - band
    n_rows = torch.where((ql >= 1) & (ql <= Lq), ql, 0)
    rs = (-(off + band)).clamp(min=0)
    live = (tl >= 0) & (n_rows >= rs)
    span = torch.where(live, n_rows - rs, 0)
    steps = int(torch.where(span > 0, span + P - 1, 0).max())

    def t_at(idx):
        flat = idx.clamp(0, Lt - 1).reshape(B, -1)
        return torch.gather(t, 1, flat).reshape(idx.shape)

    def q_at(idx):
        got = torch.gather(q, 1, idx.clamp(0, Lq - 1))
        return torch.where(idx < Lq, got, 0)

    k = k0[:, :, None] + torch.arange(S)[None, None, :]          # [1, P, S]
    j = (c + rs)[:, None, None] + k
    row0 = torch.where((k < K) & (j >= 0) & (j <= tl[:, None, None]), 0,
                       BIG)
    at_zero = torch.where(k == K - 1, (rs * gap_cost).clamp(max=BIG)
                          [:, None, None], BIG)
    cur = torch.where((rs == 0)[:, None, None], row0, at_zero)
    gp = torch.where(k == K, BIG, gap_cost).expand(B, P, S)
    ib = (rs + c)[:, None] + k0 - lanes
    tc = t_at(ib[:, :, None] + torch.arange(S))
    qc = torch.zeros(B, P, dtype=torch.long)
    qc[:, 0] = q_at(rs[:, None])[:, 0]
    tail0 = rs + c + (P - 1) * (S - 1) + S - 1

    def chunk(u0):
        u = u0 + lanes
        return q_at(rs[:, None] + u) | (t_at(tail0[:, None] + u) << 8)

    ck_cur, ck_next = chunk(0), chunk(P)
    gp_next = torch.where(k0 + S == K, BIG, gap_cost)
    for tau in range(steps):
        active = ((tau - lanes) >= 0) & ((tau - lanes) < span[:, None])
        up = cur[:, :, 1] if S > 1 else torch.full_like(cur[:, :, 0], BIG)
        m0 = torch.minimum(up + gap_cost, cur[:, :, 0] + torch.where(
            tc[:, :, 0] == qc, 0, sub_cost))
        carry = _up(cur[:, :, S - 1])
        carry[:, 0] = BIG
        m0_next = _down(torch.where(active, m0, cur[:, :, 0]))
        up_last = torch.minimum(cur[:, :, S - 1] + gp_next, m0_next)
        up_last[:, P - 1] = BIG
        cur[:, :, 0] = torch.where(
            active, torch.minimum(carry + gp[:, :, 0], m0), cur[:, :, 0])
        for s in range(1, S):
            up = cur[:, :, s + 1] if s + 1 < S else up_last
            diag = cur[:, :, s] + torch.where(tc[:, :, s] == qc, 0, sub_cost)
            new = torch.minimum(cur[:, :, s - 1] + gp[:, :, s],
                                torch.minimum(up + gap_cost, diag))
            cur[:, :, s] = torch.where(active, new, cur[:, :, s])
        u = tau + 1
        if u % P == 0:
            ck_cur, ck_next = ck_next, chunk(u + P)
        edge = ck_cur[:, u % P][:, None]
        qc = torch.where(lanes == 0, edge & 0xFF, _up(qc))
        t_in = _down(tc[:, :, 1 if S > 1 else 0])
        last = torch.where(lanes == P - 1, edge >> 8, t_in)
        tc = torch.cat([tc[:, :, 1:], last[:, :, None]], 2)

    jb = ql + c
    jf = jb[:, None, None] + k
    ok = live[:, None, None] & (k < K) & (jf >= 0) & (jf <= tl[:, None, None])
    vals = torch.where(ok, cur, BIG).reshape(B, P * S)
    best = vals.min(1).values
    best_k = torch.argmin(vals, 1)            # the lowest slot among ties
    cost = torch.where(best < BIG, best, BIG)
    t_end = torch.where(best < BIG, jb + best_k, -1)
    return cost.int(), t_end.int()


def _batch(rng, B, Lq, Lt, band):
    """Half the problems copy a target window into the query (with a few
    edits), ragged q_len with some 0 and some = Lq, t_len shorter than the
    band for some, and offsets at both edges of [-(Lq + band), Lt + band],
    one past them, and inside."""
    K = 2 * band + 1
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    off = rng.integers(-(Lq + band) - 3, Lt + band + 4, B).astype(np.int32)
    for i in range(0, B, 2):
        o = int(rng.integers(0, max(1, Lt - Lq)))
        n = min(Lq, Lt - o)
        q[i, :n] = t[i, o:o + n]
        p = rng.integers(0, Lq, int(rng.integers(0, 4)))
        q[i, p] = rng.integers(0, 5, len(p))
        off[i] = o + int(rng.integers(-(band // 2), band // 2 + 1))
    edges = [-(Lq + band), -(Lq + band) + 1, -(Lq + band) - 1, Lt + band,
             Lt + band - 1, Lt + band + 1, -band - 1, band + 1]
    off[1:2 * len(edges):2] = edges[:len(off[1:2 * len(edges):2])]
    q[rng.random((B, Lq)) < 0.03] = 4
    t[rng.random((B, Lt)) < 0.02] = 4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    ql[::7] = 0
    ql[3::5] = Lq
    tl = rng.integers(Lq // 2, Lt + 1, B).astype(np.int32)
    tl[5::6] = rng.integers(1, max(2, min(Lt, K)), len(tl[5::6]))
    q = np.where(np.arange(Lq)[None, :] < ql[:, None], q, 4).astype(np.uint8)
    return [torch.from_numpy(a) for a in (q, ql, t, tl, off)]


SHAPES = {0: (24, 40), 1: (24, 40), 15: (30, 70), 16: (30, 72),
          96: (40, 240), 192: (40, 440), 255: (20, 540)}


@pytest.mark.parametrize("band", sorted(SHAPES))
def test_emulation_matches_plain(band):
    rng = np.random.default_rng(7000 + band)
    Lq, Lt = SHAPES[band]
    arrays = _batch(rng, 36, Lq, Lt, band)
    K = 2 * band + 1
    plans = sorted({plan_lanes(8, K), plan_lanes(16_384, K)})
    for sc, gc in ((1, 1), (2, 3)):
        want = bg.banded_general_plain(*arrays, band=band, sub_cost=sc,
                                       gap_cost=gc)
        assert (want[0] < BIG).sum() > 5 and (want[0] >= BIG).sum() > 2
        for P in plans:
            got = emulate(*arrays, band, sc, gc, P)
            assert torch.equal(got[0], want[0]), (band, sc, gc, P)
            assert torch.equal(got[1], want[1]), (band, sc, gc, P)


@pytest.mark.parametrize("band", [1, 15, 16, 192])
def test_plans_keep_two_slots_a_lane(band):
    """Every plan gives each lane two slots or the problem one lane, and at
    most 16 slots a lane (the kernel's templates)."""
    K = 2 * band + 1
    for B in (1, 8, 1024, 1025, 16_384):
        P = plan_lanes(B, K)
        S = -(-K // P)
        assert P in (1, 2, 4, 8, 16, 32) and S <= 16
        assert S >= 2 or P == 1


def test_one_slot_a_lane_breaks_the_wavefront():
    """With S = 1 on 32 lanes, a lane's `up` would be its right neighbour's
    value of the same step, which the schedule has not computed yet: the
    emulation then differs from the plain version, so it can see a wrong
    dependency order."""
    rng = np.random.default_rng(11)
    arrays = _batch(rng, 24, 30, 70, 15)
    want = bg.banded_general_plain(*arrays, band=15)
    got = emulate(*arrays, 15, 1, 1, 32)
    assert not torch.equal(got[0], want[0])


@pytest.mark.parametrize("maker,B,Lq,Lt,band", [
    ("patch_problems", 8, 64, 512, 192), ("patch_problems", 8, 128, 512, 48),
    ("edge_problems", 48, 24, 60, 16), ("edge_problems", 48, 24, 60, 1)])
def test_emulation_on_the_smoke_inputs(maker, B, Lq, Lt, band):
    """chip_smoke's makers of phase-6 inputs at the callers' shapes: the
    emulated schedule under the latency plan == the plain version; the
    patch_gaps-like problems align (all but the padding row), and the edge
    set holds both found and infeasible problems. (The padding row, q_len
    = t_len = 0, finds cost 0 at column 0, as the plain version says.)"""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rng = np.random.default_rng(B + Lq + band)
    arrays = [torch.from_numpy(a) for a in
              getattr(chip_smoke, maker)(rng, B, Lq, Lt, band)]
    want = bg.banded_general_plain(*arrays, band=band)
    got = emulate(*arrays, band, 1, 1, plan_lanes(B, 2 * band + 1))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    found = int((want[0] < BIG).sum())
    if maker == "patch_problems":
        assert found == B and int(want[0].max()) <= Lq // 10
    else:
        assert 0 < found < B

"""Port Ultra long-read correction (long/ultra.py) vs the reference.

The banded-vote DP (forward pass and traceback) must give the reference's
event arrays, equal as arrays: the same events in the same order, chunk
by chunk (here chunks of 16 problems), step-major within a chunk.

friend_hits and correct_long_reads run at 20 kb (15x CLR reads, 15 %
error, 2 rounds) through both packages. The reference sorts its friend
k-mers with `lax.sort(..., is_stable=False)` (long/ultra.py:91-94), so the
order of a run's (read, pos) tuples is XLA's; the port sorts stably, from
read-major, pos-ascending order. Against the reference with that one sort
made stable, every array and every corrected read is equal. Against the
reference as it is, the hits are the same multiset in another order; that
order decides which hit of a (read, friend, window) is kept. On this
input round 0 keeps the same hits in either order, so the reference as it
is corrects round 0 as the stable one does and is run here from round 1
on; round 1 corrects differently (ROADMAP Queue 3). Given the reference's
own round-1 hit order, the port builds the reference's DP problems and,
with the reference's events for them, corrects round 1 as it does.

The traceback's alive threshold is float32 on the reference's device path
(1.3 * 90 -> 116) and float64 in its host oracle (117): a problem of
window length 90 whose best cost is 116 is dropped by both device paths
and kept by the host oracle.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
from jax import lax  # noqa: E402

from allpathslg_tpu.eval import sim  # noqa: E402
from allpathslg_tpu.long import ultra as r_ultra  # noqa: E402
from allpathslg_tpu_torch.long import ultra as t_ultra  # noqa: E402

torch.set_num_threads(2)
ROUNDS = 2


def _votes_batch(seed=5, B=37, Lt=64, Lq=96, band=16, ragged=False):
    """tests/test_ultra.py's problems (noisy fragments of random windows,
    one empty window, one empty fragment); `ragged` adds short windows
    and fragments and N codes."""
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    frag = np.full((B, Lq), 4, np.uint8)
    flen = np.zeros(B, np.int64)
    wlen = np.full(B, Lt, np.int64)
    for b in range(B):
        out = []
        for x in win[b].tolist():
            r = rng.random()
            if r < 0.08:
                continue
            out.append(int(rng.integers(0, 4)) if r < 0.16 else x)
            if rng.random() < 0.08:
                out.append(int(rng.integers(0, 4)))
        out = ([int(rng.integers(0, 4))] * band + out)[:Lq]
        frag[b, :len(out)] = out
        flen[b] = len(out)
    wlen[3] = 0
    flen[5] = 0
    if ragged:
        for b in range(0, B, 4):
            wlen[b] = rng.integers(1, Lt)
            win[b, wlen[b]:] = 4
        for b in range(1, B, 5):
            flen[b] = rng.integers(band // 2, Lq)
            frag[b, flen[b]:] = 4
        win[rng.random((B, Lt)) < 0.02] = 4
        frag[rng.random((B, Lq)) < 0.02] = 4
    return win, frag, flen, wlen, band


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _events(ev):
    i, k, b, p = ev
    return Counter(zip(p.tolist(), i.tolist(), k.tolist(), b.tolist()))


@pytest.mark.parametrize("ragged", [False, True], ids=["reference", "ragged"])
def test_banded_votes_equal_reference(ragged):
    win, frag, flen, wlen, band = _votes_batch(ragged=ragged)
    want = r_ultra._banded_votes(win, frag, flen, wlen, band, 3, 2, chunk=16)
    got = t_ultra._banded_votes(win, frag, flen, wlen, band, 3, 2, chunk=16,
                                device="cpu")
    _same_arrays(got, want)
    one = t_ultra._banded_votes(win, frag, flen, wlen, band, 3, 2,
                                device="cpu")
    _same_arrays(one, r_ultra._banded_votes(win, frag, flen, wlen, band,
                                            3, 2))
    # the host oracle (a copy) holds the same events as a multiset
    host = t_ultra._banded_votes_host(win, frag, flen, wlen, band, 3, 2)
    _same_arrays(host, r_ultra._banded_votes_host(win, frag, flen, wlen,
                                                  band, 3, 2))
    assert _events(host) == _events(got)
    assert not (got[3] == 3).any() and len(got[0]) > 0


def test_alive_threshold_is_float32():
    assert int(np.float32(1.3) * np.float32(90)) == 116
    assert int(np.int64(1.3 * 90)) == 117
    band, Lt, W = 16, 96, 90
    Lq = Lt + 2 * band
    rng = np.random.default_rng(0)
    B = 400
    win = np.full((B, Lt), 4, np.uint8)
    win[:, :W] = 0
    frag = np.ones((B, Lq), np.uint8)
    for b in range(B):
        frag[b, rng.random(Lq) < (b / B) * 0.6] = 0
    win, frag = win[360:], frag[360:]
    flen = np.full(len(win), Lq, np.int64)
    wlen = np.full(len(win), W, np.int64)
    _, dend = t_ultra._votes_forward(
        *(torch.from_numpy(x) for x in (win, frag)),
        torch.from_numpy(flen).int(), torch.from_numpy(wlen).int(), Lt, Lq,
        band, 3, 2)
    best = dend.min(dim=1).values.numpy()
    at116 = np.nonzero(best == 116)[0]
    assert len(at116) > 0
    got = t_ultra._banded_votes(win, frag, flen, wlen, band, 3, 2,
                                device="cpu")
    _same_arrays(got, r_ultra._banded_votes(win, frag, flen, wlen, band,
                                            3, 2))
    host = r_ultra._banded_votes_host(win, frag, flen, wlen, band, 3, 2)
    for p in at116:
        assert not (got[3] == p).any()          # dropped: 116 < 116 fails
        assert (host[3] == p).sum() >= W        # kept: 116 < 117
    # every other problem: the same events on both paths
    others = ~np.isin(host[3], at116)
    assert _events(tuple(x[others] for x in host)) == _events(got)


@pytest.fixture(scope="module")
def clr20():
    g = sim.random_genome(20_000, seed=3)
    reads, _, _ = sim.simulate_long_reads(g, coverage=15, mean_len=4000,
                                          error_rate=0.15, seed=7)
    return reads


R_FRIEND_HITS = r_ultra.friend_hits


def _stable_sort(reads, **kw):
    """The reference's friend_hits with its friend sort made stable."""
    orig = lax.sort
    lax.sort = lambda *a, **k: orig(*a, **{**k, "is_stable": True})
    try:
        return R_FRIEND_HITS(reads, **kw)
    finally:
        lax.sort = orig


def _kept(fn, calls):
    """fn that appends each call's (positional arguments, result) to
    `calls`."""
    def kept(*a, **kw):
        out = fn(*a, **kw)
        calls.append((a, out))
        return out
    return kept


@pytest.fixture(scope="module")
def references(clr20):
    """The reference with its friend sort made stable: both rounds, each
    round's input reads and hits kept. The reference as it is: its round-0
    hits, and its round 1 on the stable run's round-1 input, with the hits
    and the DP problems and events of that round."""
    cfg = r_ultra.UltraConfig(rounds=ROUNDS)
    stable_calls, as_is_calls, dp_calls = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_ultra, "friend_hits", _kept(_stable_sort, stable_calls))
        stable = r_ultra.correct_long_reads(clr20, cfg)
    as_is_hits0 = r_ultra.friend_hits(clr20)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(r_ultra, "friend_hits", _kept(R_FRIEND_HITS, as_is_calls))
        mp.setattr(r_ultra, "_banded_votes",
                   _kept(r_ultra._banded_votes, dp_calls))
        as_is_round1 = r_ultra.correct_round(stable_calls[1][0][0], cfg)
    return {"stable": stable, "stable_calls": stable_calls,
            "as_is_hits0": as_is_hits0, "as_is_round1": as_is_round1,
            "as_is_hits1": as_is_calls[0][1], "as_is_dp1": dp_calls[0]}


def _same_reads(got, want):
    (cg, mg), (cw, mw) = got, want
    assert mg == mw
    assert len(cg) == len(cw)
    for x, y in zip(cg, cw):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_friend_hits_equal_stable_reference(clr20, references):
    hits = t_ultra.friend_hits(clr20, device="cpu")
    _same_arrays(hits, references["stable_calls"][0][1])
    assert len(hits[0]) > 10_000
    # the reference as it is: the same hits in another order
    as_is = references["as_is_hits0"]
    o_t, o_r = np.lexsort(hits[::-1]), np.lexsort(as_is[::-1])
    _same_arrays(tuple(x[o_t] for x in hits),
                 tuple(np.asarray(x)[o_r] for x in as_is))


def test_correct_long_reads_equal_stable_reference(clr20, references):
    cfg = t_ultra.UltraConfig(rounds=ROUNDS)
    got = t_ultra.correct_long_reads(clr20, cfg, device="cpu")
    _same_reads(got, references["stable"])
    assert got[1]["round0_events"] > 0


def test_unstable_reference_differs_only_by_hit_order(clr20, references,
                                                      monkeypatch):
    """The reference as it is corrects otherwise than with a stable sort
    (ROADMAP Queue 3); the port fed the reference's own hit order corrects
    as the reference does, so the hit order is the whole difference."""
    cfg = t_ultra.UltraConfig(rounds=ROUNDS)
    # round 0: either hit order keeps the same hits, so the reference as
    # it is corrects round 0 as the stable one does
    _same_arrays(t_ultra._select_hits(*references["as_is_hits0"], cfg),
                 t_ultra._select_hits(*references["stable_calls"][0][1],
                                      cfg))
    # round 1: the two orders correct differently
    (reads1,), hits1 = references["stable_calls"][1]
    (as_is, n_as_is), (stable, _) = (references["as_is_round1"],
                                     references["stable"])
    assert n_as_is != references["stable"][1]["round1_events"] or any(
        not np.array_equal(x, y) for x, y in zip(as_is, stable))
    assert not all(np.array_equal(x, y) for x, y in
                   zip(references["as_is_hits1"], hits1))
    # the port fed the reference's round-1 hits builds the reference's DP
    # problems; given the reference's events for them (the DP itself is
    # held above), it corrects as the reference does
    dp_in, dp_out = references["as_is_dp1"]

    def votes(win, frag, flen, wlen, **kw):
        _same_arrays((win, frag, flen, wlen), dp_in)
        return dp_out

    monkeypatch.setattr(t_ultra, "friend_hits",
                        lambda reads, K, max_run, device:
                        references["as_is_hits1"])
    monkeypatch.setattr(t_ultra, "_banded_votes", votes)
    got = t_ultra.correct_round(reads1, cfg, device="cpu")
    _same_reads(got, references["as_is_round1"])


@pytest.mark.cuda
def test_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    win, frag, flen, wlen, band = _votes_batch(ragged=True)
    _same_arrays(t_ultra._banded_votes(win, frag, flen, wlen, band, 3, 2,
                                       chunk=16, device="cuda"),
                 t_ultra._banded_votes(win, frag, flen, wlen, band, 3, 2,
                                       chunk=16, device="cpu"))

"""Port one-hot scan lookup (align/mxu_scan.py) vs the reference.

tests/test_mxu_scan.py's five cases run through the reference's jnp
functions and the port's torch ones on the same numpy inputs: match
counts, (pos, is_rc, mismatches) and (pos, is_rc, n_hits) must be equal,
exactly. A case at L = 300 holds counts above 256, which a bf16 output
would round, against a plain integer count. The `cuda`-marked case holds
the card against the CPU and skips without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.align import mxu_scan as rmx  # noqa: E402
from allpathslg_tpu.eval import sim  # noqa: E402
from allpathslg_tpu_torch.align import mxu_scan as tmx  # noqa: E402

torch.set_num_threads(2)


def _rc(s):
    return (3 - s[::-1]).astype(np.uint8)


def _int_counts(target, reads):
    """sum_j [target[p + j] == read[j] < 4], by integer compares."""
    N, L = reads.shape
    win = np.lib.stride_tricks.sliding_window_view(target, L)
    return np.stack([((win == r) & (r < 4)).sum(axis=1) for r in reads]
                    ).astype(np.int32)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _lookups(target, reads, lengths):
    args_r = [jnp.asarray(a) for a in (target, reads, lengths)]
    args_t = [torch.from_numpy(np.ascontiguousarray(a))
              for a in (target, reads, lengths)]
    _same(tmx.imperfect_lookup(*args_t), rmx.imperfect_lookup(*args_r))
    _same(tmx.perfect_lookup(*args_t), rmx.perfect_lookup(*args_r))
    return [x.numpy() for x in tmx.imperfect_lookup(*args_t)]


def test_match_counts():
    target = sim.random_genome(300, seed=1)
    reads = np.stack([target[i:i + 40] for i in (3, 50, 120)])
    mc = tmx.match_counts(torch.from_numpy(target), torch.from_numpy(reads))
    _same(mc, rmx.match_counts(jnp.asarray(target), jnp.asarray(reads)))
    np.testing.assert_array_equal(mc.numpy(), _int_counts(target, reads))
    assert mc[0, 3] == 40


def test_imperfect_lookup_planted_reads():
    target = sim.random_genome(2000, seed=2)
    rng = np.random.default_rng(3)
    L, n = 60, 40
    starts = rng.integers(0, len(target) - L, n)
    is_rc = rng.random(n) < 0.5
    reads = np.zeros((n, L), np.uint8)
    for i, (s, rc) in enumerate(zip(starts, is_rc)):
        seg = target[s:s + L].copy()
        pp = rng.choice(L, 2, replace=False)
        seg[pp] = (seg[pp] + rng.integers(1, 4, 2)) % 4
        reads[i] = _rc(seg) if rc else seg
    pos, urc, mism = _lookups(target, reads, np.full(n, L, np.int32))
    assert (pos == starts).all() and (urc == is_rc).all()
    assert (mism <= 2).all()


def test_imperfect_lookup_ragged_rc_offsets():
    target = sim.random_genome(800, seed=5)
    L, ln, s = 50, 37, 333
    seg = target[s:s + ln]
    fwd = np.full((1, L), 4, np.uint8)
    fwd[0, :ln] = seg
    rcr = np.full((1, L), 4, np.uint8)
    rcr[0, :ln] = _rc(seg)
    for reads, want_rc in ((fwd, False), (rcr, True)):
        pos, urc, mism = _lookups(target, reads, np.asarray([ln], np.int32))
        assert (int(pos[0]), bool(urc[0]), int(mism[0])) == (s, want_rc, 0)


def test_imperfect_random_reads_ties():
    """Random reads against a short target: many tied best offsets, which
    go to the lowest offset and the forward strand in both packages."""
    target = sim.random_genome(400, seed=7)
    reads = np.random.default_rng(8).integers(0, 4, (12, 30)
                                              ).astype(np.uint8)
    _lookups(target, reads, np.full(12, 30, np.int32))


def test_perfect_lookup_repeat_hits():
    rep = sim.random_genome(45, seed=11)
    target = np.concatenate([sim.random_genome(200, seed=12), rep,
                             sim.random_genome(200, seed=13), rep,
                             sim.random_genome(200, seed=14)])
    reads = np.stack([rep, _rc(rep)])
    args = [torch.from_numpy(a) for a in (target, reads,
                                          np.full(2, 45, np.int32))]
    _lookups(target, reads, np.full(2, 45, np.int32))
    pos, is_rc, n_hits = (x.numpy() for x in tmx.perfect_lookup(*args))
    assert (n_hits == 2).all()
    assert set(pos[0][pos[0] >= 0]) == {200, 445}
    assert set(pos[1][pos[1] >= 0]) == {200, 445}
    assert not is_rc[0][:2].any() and is_rc[1][:2].all()


def _long_reads(G=3000, n=24, L=300, seed=21):
    """Reads of L = 300 planted with 0-3 substitutions on both strands,
    ragged tails, and a target with N runs."""
    target = sim.random_genome(G, seed=seed)
    target[100:110] = 4
    rng = np.random.default_rng(seed + 1)
    reads = np.full((n, L), 4, np.uint8)
    lengths = rng.integers(L - 40, L + 1, n).astype(np.int32)
    lengths[:4] = L
    for i in range(n):
        ln = int(lengths[i])
        s = int(rng.integers(0, G - ln))
        seg = target[s:s + ln].copy()
        pp = rng.choice(ln, int(rng.integers(0, 4)), replace=False)
        seg[pp] = (seg[pp] + 1) % 4
        reads[i, :ln] = _rc(seg) if i % 2 else seg
    reads[3] = target[500:500 + L]        # one read with a full count
    return target, reads, lengths


def test_read_length_300_counts_exact():
    target, reads, lengths = _long_reads()
    mc = tmx.match_counts(torch.from_numpy(target), torch.from_numpy(reads))
    want = _int_counts(target, reads)
    np.testing.assert_array_equal(mc.numpy(), want)
    assert mc.max() == 300 and (want > 256).sum() > 0
    _same(mc, rmx.match_counts(jnp.asarray(target), jnp.asarray(reads)))
    _lookups(target, reads, lengths)


@pytest.mark.cuda
def test_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    target, reads, lengths = _long_reads()
    cpu = [torch.from_numpy(a) for a in (target, reads, lengths)]
    for fn in (tmx.imperfect_lookup, tmx.perfect_lookup):
        for g, w in zip(fn(*(a.cuda() for a in cpu)), fn(*cpu)):
            assert torch.equal(g.cpu(), w)
    assert torch.equal(tmx.match_counts(*(a.cuda() for a in cpu[:2])).cpu(),
                       tmx.match_counts(*cpu[:2]))

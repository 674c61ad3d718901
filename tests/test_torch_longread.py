"""The port's long-read patcher and consensus == the reference's.

The same numpy inputs (the reference tests' seeds: tests/test_longread.py's
constructed 1.5 kb gap and tests/test_consensus.py's noisy stacks) go
through allpathslg_tpu.asm.longread / long.consensus and their ports;
integer outputs must be equal. On the CPU the port runs its plain banded
DP; the reference runs its own (JAX on the CPU). The port's array-based
flank anchoring is held against the reference's per-base `_anchor` over
random reads and over reads built so that two diagonal bins tie.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.asm import longread as rlr  # noqa: E402
from allpathslg_tpu.long import consensus as rcons  # noqa: E402
from allpathslg_tpu_torch.asm import longread as tlr  # noqa: E402
from allpathslg_tpu_torch.eval import sim  # noqa: E402
from allpathslg_tpu_torch.long import consensus as tcons  # noqa: E402

torch.set_num_threads(2)
CFG = tlr.LongReadConfig()
RCFG = rlr.LongReadConfig()


@pytest.fixture(scope="module")
def gap_setup():
    genome = sim.random_genome(30_000, seed=60)
    c1 = genome[:12_000]
    c2 = genome[13_500:26_000]
    reads, _, _ = sim.simulate_long_reads(
        genome, coverage=12, mean_len=6000, error_rate=0.12, seed=61)
    return genome, c1, c2, reads


def _same_list(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_find_gap_segments_equal(gap_setup):
    _, c1, c2, reads = gap_setup
    tail, head = c1[-CFG.flank:], c2[:CFG.flank]
    ref = rlr.find_gap_segments(reads, tail, head, RCFG)
    port = tlr.find_gap_segments(reads, tail, head, CFG)
    assert len(ref) >= 3
    _same_list(ref, port)


def test_consensus_patch_equal(gap_setup):
    _, c1, c2, reads = gap_setup
    segs = rlr.find_gap_segments(reads, c1[-500:], c2[:500], RCFG)
    ref = rlr.consensus_patch(segs, RCFG)
    port = tlr.consensus_patch(segs, CFG, device="cpu")
    assert ref.tobytes() == port.tobytes()


@pytest.mark.parametrize("case", ["spanning", "unrelated"])
def test_close_gap_equal(gap_setup, case):
    _, c1, c2, reads = gap_setup
    if case == "unrelated":
        other = sim.random_genome(30_000, seed=99)
        reads, _, _ = sim.simulate_long_reads(other, coverage=10, seed=100)
    ref = rlr.close_gap_with_long_reads(c1, c2, gap=1500, dev=60,
                                        long_reads=reads)
    port = tlr.close_gap_with_long_reads(c1, c2, gap=1500, dev=60,
                                         long_reads=reads, device="cpu")
    if case == "unrelated":
        assert ref is None and port is None
    else:
        assert ref is not None and ref.tobytes() == port.tobytes()


def _ref_anchors(reads, flank):
    table = rlr._kmer_positions(flank, RCFG.K)
    out = []
    for r in reads:
        for read in (r, rlr._rc(r)):
            v, d = rlr._anchor(read, table, len(flank), RCFG)
            out.append((v, d))
    return out


def _port_anchors(reads, flank):
    index = tlr.LongReadIndex(reads, CFG.K)
    votes, diag = tlr._anchor_all(index, flank, CFG)
    return [(int(v), int(d) if v else None) for v, d in zip(votes, diag)]


def test_anchoring_equals_reference_on_random_reads():
    """>= 200 reads: simulated long reads on and off the flank's genome,
    a few with N runs, in both orientations, against both flanks."""
    genome = sim.random_genome(20_000, seed=5)
    reads, _, _ = sim.simulate_long_reads(genome, coverage=20, mean_len=1500,
                                          error_rate=0.12, seed=6)
    other, _, _ = sim.simulate_long_reads(sim.random_genome(8_000, seed=7),
                                          coverage=5, mean_len=1500, seed=8)
    reads = list(reads) + list(other)
    rng = np.random.default_rng(9)
    for i in rng.choice(len(reads), 20, replace=False):
        r = reads[i].copy()
        at = int(rng.integers(0, max(len(r) - 30, 1)))
        r[at:at + int(rng.integers(1, 30))] = 4
        reads[i] = r
    reads.append(np.zeros(0, np.uint8))
    reads.append(genome[9_000:9_010].copy())      # shorter than K
    assert len(reads) >= 200
    for flank in (genome[9_500:10_000], genome[12_000:12_500]):
        ref = _ref_anchors(reads, flank)
        port = _port_anchors(reads, flank)
        assert sum(v > 0 for v, _ in ref) > 20
        assert ref == port


def _tie_read(flank, rng, first, second):
    """A read holding flank[a1:a1+40] at p1 then, after random bases,
    flank[a2:a2+40] at p2 ((a, p) = first, second): two diagonal bins with
    29 votes each."""
    r = rng.integers(0, 4, second[1] + 40 + 50).astype(np.uint8)
    for a, p in (first, second):
        r[p:p + 40] = flank[a:a + 40]
        # the bases either side differ from the flank's, so no match
        # extends past the 40
        r[p - 1] = (flank[a - 1] + 1) % 4
        r[p + 40] = (flank[a + 40] + 1) % 4
    return r


def test_anchoring_ties_go_to_the_first_inserted_bin():
    """Two bins with equal votes: the reference's max over an
    insertion-ordered dict keeps the bin voted first in scan order (read
    position ascending), whatever the bins' values; so does the port."""
    rng = np.random.default_rng(3)
    flank = rng.integers(0, 4, 500).astype(np.uint8)
    cases = [
        ((400, 10), (20, 300)),     # first segment has the higher diagonal
        ((20, 10), (400, 300)),     # first segment has the lower diagonal
        ((100, 200), (300, 260)),   # close together, still two bins
    ]
    reads = [_tie_read(flank, rng, f, s) for f, s in cases]
    ref = _ref_anchors(reads, flank)
    port = _port_anchors(reads, flank)
    assert ref == port
    for i, ((a1, p1), (a2, p2)) in enumerate(cases):
        d1 = (a1 - p1) // 64 * 64 + 32
        d2 = (a2 - p2) // 64 * 64 + 32
        assert d1 != d2
        v, d = port[2 * i]
        assert v == 29 and d == d1, (i, v, d, d1, d2)


def _noisy(truth, rng, err=0.04):
    seq = truth.copy()
    m = rng.random(len(seq)) < err
    seq[m] = (seq[m] + rng.integers(1, 4, m.sum())) % 4
    if rng.random() < 0.7 and len(seq) > 20:
        p = int(rng.integers(5, len(seq) - 5))
        if rng.random() < 0.5:
            seq = np.delete(seq, p)
        else:
            seq = np.insert(seq, p, rng.integers(0, 4))
    return seq.astype(np.uint8)


def _stack(seed, n_reads, length, err):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 4, length).astype(np.uint8)
    return truth, [_noisy(truth, rng, err=err) for _ in range(n_reads)]


def test_stack_votes_equal():
    truth, reads = _stack(0, 12, 160, 0.02)
    offs = [0, 3, -5, 10] * 3
    assert (rcons.stack_votes(truth, reads, offs).tobytes()
            == tcons.stack_votes(truth, reads, offs).tobytes())


@pytest.mark.parametrize("band", [6, 8])
def test_score_stack_equal(band):
    truth, reads = _stack(1, 10, 120, 0.03)
    bad = np.delete(truth.copy(), 70)
    for cand in (truth, bad):
        assert (rcons.score_stack(cand, reads, [0] * 10, band=band)
                == tcons.score_stack(cand, reads, [0] * 10, band=band,
                                     device="cpu"))


@pytest.mark.parametrize("case", ["seed_errors", "clean_stack"])
def test_refine_consensus_equal(case):
    if case == "seed_errors":
        truth, reads = _stack(0, 12, 160, 0.02)
        seed = truth.copy()
        seed[30] = (seed[30] + 1) % 4
        seed[80] = (seed[80] + 2) % 4
        seed[120] = (seed[120] + 1) % 4
        seed = np.delete(seed, 60)
        rc = rcons.ConsensusConfig(rounds=4)
        tc = tcons.ConsensusConfig(rounds=4)
    else:
        rng = np.random.default_rng(2)
        truth = rng.integers(0, 4, 100).astype(np.uint8)
        reads = [truth.copy() for _ in range(8)]
        seed = truth
        rc, tc = rcons.ConsensusConfig(), tcons.ConsensusConfig()
    r_cons, r_n = rcons.refine_consensus(seed, reads, [0] * len(reads), rc)
    t_cons, t_n = tcons.refine_consensus(seed, reads, [0] * len(reads), tc,
                                         device="cpu")
    assert r_cons.tobytes() == t_cons.tobytes() and r_n == t_n
    if case == "seed_errors":
        assert t_n > 0 and int((t_cons != truth).sum()) <= 1

"""Port seed-and-verify aligner (align/lookup.py) vs the reference.

Both packages build the seed index of the same two contigs (packed and
legacy row layouts) and align the same reads; every index array and every
alignlet array must be equal. The read sets follow tests/test_align.py:
simulated reads with substitution errors, and reads carrying a 1-base
deletion or insertion that only the banded-DP rescue places. On the CPU
the rescue takes the plain `banded_align`, as the reference's does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.align import lookup as rlookup  # noqa: E402
from allpathslg_tpu.eval import sim  # noqa: E402
from allpathslg_tpu_torch import convert  # noqa: E402
from allpathslg_tpu_torch.align import lookup as tlookup  # noqa: E402

torch.set_num_threads(2)
L = 100


@pytest.fixture(scope="module")
def setup():
    genome = sim.random_genome(25_000, seed=40)
    c0, c1 = genome[:12_000], genome[12_500:]
    bases = np.concatenate([c0, c1])
    offsets = np.array([0, len(c0), len(c0) + len(c1)], np.int64)
    batch, _, _ = sim.simulate_paired_reads(genome, coverage=4,
                                            error_rate=0.01, seed=41)
    return genome, bases, offsets, np.asarray(batch.codes), \
        np.asarray(batch.lengths)


def _indel_reads(genome, n=384, seed=9):
    """Clean reads, 1-base deletions and 1-base insertions, in turns
    (tests/test_align.py), with ragged lengths and a few N bases."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 12_000 - L - 2, n)
    reads = np.zeros((n, L), np.uint8)
    for i, s in enumerate(starts):
        seg = genome[s: s + L + 1].copy()
        p = int(rng.integers(20, 80))
        if i % 3 == 0:
            reads[i] = seg[:L]
        elif i % 3 == 1:
            reads[i] = np.concatenate([seg[:p], seg[p + 1: L + 1]])
        else:
            reads[i] = np.concatenate([seg[:p], rng.integers(0, 4, 1)
                                       .astype(np.uint8), seg[p: L - 1]])
    lengths = np.full(n, L, np.int32)
    lengths[::5] = rng.integers(60, L, len(lengths[::5]))
    reads[np.arange(L)[None, :] >= lengths[:, None]] = 4
    reads[7::11, 50] = 4
    return reads, lengths


def _index_arrays(ix):
    names = ("hash", "bucket_starts", "contig", "pos", "is_rc", "offsets",
             "packed")
    out = {}
    for k in names:
        v = getattr(ix, k)
        out[k] = None if v is None else (
            v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
    return out


@pytest.mark.parametrize("legacy", [False, True], ids=["packed", "legacy"])
def test_build_index_matches_reference(setup, legacy):
    _, bases, offsets, _, _ = setup
    ref = rlookup.build_index(bases, offsets, K=24, force_legacy=legacy)
    port = tlookup.build_index(bases, offsets, K=24, force_legacy=legacy,
                                device="cpu")
    assert (port.packed is None) == legacy
    assert port.shift == ref.shift and port.K == ref.K
    np.testing.assert_array_equal(port.contig_lens, ref.contig_lens)
    a, b = _index_arrays(ref), _index_arrays(port)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
            continue
        # words: uint32 in the reference, int64 holding uint32 here
        np.testing.assert_array_equal(a[k].astype(np.int64),
                                      b[k].astype(np.int64), err_msg=k)


def _align_both(setup, codes, lengths, cfg_kw, legacy=False):
    _, bases, offsets, _, _ = setup
    ref_ix = rlookup.build_index(bases, offsets, K=24, force_legacy=legacy)
    port_ix = tlookup.build_index(bases, offsets, K=24, force_legacy=legacy,
                                   device="cpu")
    want = rlookup.align_reads(ref_ix, codes, lengths,
                               rlookup.AlignConfig(**cfg_kw), bases)
    got = tlookup.align_reads(port_ix, codes, lengths,
                              tlookup.AlignConfig(**cfg_kw),
                              torch.from_numpy(bases))
    return want, got


def _assert_alignlets_equal(want, got):
    for name, w, g in zip(("contig", "pos", "rc", "mismatches", "aligned"),
                          want, got):
        w = np.asarray(w)
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(w, g, err_msg=name)


@pytest.mark.parametrize("rescue_band", [0, 8])
def test_align_indel_reads_matches_reference(setup, rescue_band):
    reads, lengths = _indel_reads(setup[0])
    want, got = _align_both(setup, reads, lengths,
                            dict(rescue_band=rescue_band))
    _assert_alignlets_equal(want, got)
    ok = got[4]
    if rescue_band:
        assert ok.mean() > 0.9          # the rescue places the indel reads
    else:
        assert ok.mean() < 0.75


@pytest.mark.parametrize("legacy", [False, True], ids=["packed", "legacy"])
def test_align_simulated_reads_matches_reference(setup, legacy):
    _, _, _, codes, lengths = setup
    want, got = _align_both(setup, codes, lengths, {}, legacy=legacy)
    _assert_alignlets_equal(want, got)
    assert got[4].mean() > 0.8


def test_vote_in_slabs_matches_one_block(setup, monkeypatch):
    """The dense vote taken a few reads at a time gives the same alignlets
    as one [N, C, C] block (and as the reference)."""
    reads, lengths = _indel_reads(setup[0], n=120, seed=4)
    want, got = _align_both(setup, reads, lengths, {})
    monkeypatch.setattr(tlookup, "_VOTE_SLAB_ELEMS", 7 * 13 * 13 * 8 * 8)
    _, got_slabs = _align_both(setup, reads, lengths, {})
    _assert_alignlets_equal(want, got)
    _assert_alignlets_equal(want, got_slabs)


def test_reference_index_converts(setup):
    """convert.seed_index: the reference's index drives the port's aligner
    to the reference's alignlets."""
    _, bases, offsets, _, _ = setup
    reads, lengths = _indel_reads(setup[0], n=96, seed=5)
    ref_ix = rlookup.build_index(bases, offsets, K=24)
    cfg = dict(rescue_band=8)
    want = rlookup.align_reads(ref_ix, reads, lengths,
                               rlookup.AlignConfig(**cfg), bases)
    a = _index_arrays(ref_ix)
    ix = convert.seed_index(ref_ix.K, a["hash"], a["bucket_starts"],
                            ref_ix.shift, a["offsets"], ref_ix.contig_lens,
                            packed=a["packed"], device="cpu")
    got = tlookup.align_reads(ix, reads, lengths, tlookup.AlignConfig(**cfg),
                              bases)
    _assert_alignlets_equal(want, got)


def test_garbage_reads_unaligned(setup):
    _, bases, offsets, _, _ = setup
    junk = np.random.default_rng(5).integers(0, 4, (64, L)).astype(np.uint8)
    ix = tlookup.build_index(bases, offsets, K=24, device="cpu")
    ok = tlookup.align_reads(ix, junk, np.full(64, L, np.int32),
                             tlookup.AlignConfig(), bases)[4]
    assert ok.sum() == 0

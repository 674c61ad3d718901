"""polish's pileup of read votes: the port's plain version against the
reference's `_pileup_votes`, exactly, on the CPU; a numpy emulation of the
Hopper kernel (csrc/pileup.cu: a warp's 32 columns, its read range, the
code that lands on each lane's column) against the plain version; and, on
a card (`cuda`-marked, skips without one), the kernel against the plain
version at the shape the pipeline gives it and the polish passes on the
card against the CPU.

This file imports no JAX at module level, so that its `cuda` cases run
where JAX is absent; the reference is imported inside the one test that
uses it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from allpathslg_tpu_torch import trace  # noqa: E402
from allpathslg_tpu_torch.asm import polish as tpolish  # noqa: E402
from allpathslg_tpu_torch.eval import sim  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import pileup_cuda  # noqa: E402

CASES = ["forward_rc", "codes_ge_4", "overhang", "contigs", "segment_edge",
         "no_reads"]


def _reads(rng, contig_lens, n, L, overhang=0, n_frac=0.0, ok_frac=0.9):
    """n reads of up to L bases placed on contigs of `contig_lens`, half of
    them reverse-complemented; bytes past a read's length are random, and
    unplaced reads carry a contig and an anchor no contig has."""
    offsets = np.zeros(len(contig_lens) + 1, np.int64)
    np.cumsum(contig_lens, out=offsets[1:])
    lengths = rng.integers(L // 2, L + 1, n).astype(np.int32)
    contig = rng.integers(0, len(contig_lens), n).astype(np.int32)
    clen = np.asarray(contig_lens, np.int64)[contig]
    lo = -overhang
    hi = np.maximum(clen - lengths + overhang, lo + 1)
    start = (lo + rng.random(n) * (hi - lo)).astype(np.int64)
    rc = rng.random(n) < 0.5
    anchor = np.where(rc, start + lengths - 1, start).astype(np.int32)
    codes = rng.integers(0, 256, (n, L)).astype(np.uint8)
    inside = np.arange(L)[None, :] < lengths[:, None]
    codes[inside] = rng.integers(0, 4, int(inside.sum()))
    if n_frac:
        hit = inside & (rng.random((n, L)) < n_frac)
        codes[hit] = rng.integers(4, 256, int(hit.sum()))
    ok = rng.random(n) < ok_frac
    contig[~ok] = -1
    anchor[~ok] = 2**31 - 1
    return offsets, codes, lengths, contig, anchor, rc, ok


def _case(name):
    """(offsets, codes, lengths, al_contig, al_anchor, al_rc, al_ok, seg)."""
    rng = np.random.default_rng(CASES.index(name) + 11)
    seg = 8 << 20
    if name == "forward_rc":
        arrays = _reads(rng, [3000], 400, 60)
    elif name == "codes_ge_4":
        arrays = _reads(rng, [3000], 400, 61, n_frac=0.1)
    elif name == "overhang":
        arrays = _reads(rng, [800], 300, 61, overhang=40)
    elif name == "contigs":
        arrays = _reads(rng, [700, 1, 1500, 90, 1200], 500, 63, overhang=30)
    elif name == "segment_edge":
        arrays = _reads(rng, [2000, 1500], 400, 62, overhang=10)
        seg = 97
    else:
        arrays = _reads(rng, [1000, 500], 50, 60, ok_frac=0.0)
    return (*arrays, seg)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_reference(name):
    """The port's pileup on the CPU (the plain version) gives the JAX
    package's votes, and launches no kernel."""
    pytest.importorskip("jax")
    from allpathslg_tpu.asm import polish as rpolish

    *arrays, seg = _case(name)
    want = rpolish._pileup_votes(*arrays)
    before = trace.count("pileup")
    got = tpolish._pileup_votes(*arrays, seg=seg, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert trace.count("pileup") == before
    if name == "no_reads":
        assert not got.any()
    else:
        assert got.sum() > 0


def _emulate_kernel(offsets, codes, lengths, contig, anchor, rc, starts, s0,
                    s1):
    """csrc/pileup.cu step for step on numpy arrays: a warp for each 32
    columns, its rows found by lower bounds on `starts`, taken 32 at a
    time from the lanes that loaded their alignlets, each lane reading the
    one code of a read that lands on its column."""
    n, L = codes.shape
    flat = codes.reshape(-1)
    lane = np.arange(32)
    votes = np.zeros((s1 - s0, 4), np.int32)
    for cw in range(s0, s1, 32):
        col = cw + lane
        lo = np.searchsorted(starts, cw - L, side="left")
        hi = np.searchsorted(starts, cw + 32, side="left")
        counts = np.zeros((32, 4), np.int32)
        for r0 in range(lo, hi, 32):
            for r in range(r0, min(r0 + 32, hi)):
                length = min(int(lengths[r]), L)
                cs = int(offsets[contig[r]])
                ce = int(offsets[contig[r] + 1])
                base0 = cs + int(anchor[r])
                j = base0 - col if rc[r] else col - base0
                lands = (j >= 0) & (j < length) & (col >= cs) & (col < ce) \
                    & (col < s1)
                code = np.where(lands, flat[r * L + np.where(lands, j, 0)],
                                4).astype(np.uint32)
                b = (np.uint32(3) - code) if rc[r] else code
                for base in range(4):
                    counts[:, base] += b == base
        keep = col < s1
        votes[col[keep] - s0] = counts[keep]
    return votes


@pytest.mark.parametrize("name", CASES)
def test_kernel_emulation_matches_plain(name):
    """The kernel's index arithmetic, emulated, gives the plain version's
    votes, on all the placed reads and on the rows polish gathers for each
    segment."""
    *arrays, seg = _case(name)
    offsets, codes, lengths, contig, anchor, rc, ok = arrays
    ids, starts = tpolish._placed_by_start(offsets, lengths, contig, anchor,
                                           rc, ok)
    L = codes.shape[1]
    total = int(offsets[-1])
    for s0 in range(0, total, seg):
        s1 = min(s0 + seg, total)
        lo, hi = np.searchsorted(starts, [s0 - L, s1])
        for rows in (slice(None), slice(lo, hi)):
            args = tpolish._pileup_inputs(*arrays[:-1], ids[rows],
                                          starts[rows], device="cpu")
            want = pileup_cuda.pileup_plain(*args, s0, s1).numpy()
            got = _emulate_kernel(*[a.numpy() for a in args], s0, s1)
            assert np.array_equal(got, want), (s0, s1)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_polish_pileup.py)")
    return torch.device("cuda")


def _cell_reads(seed=7):
    """The shape polish meets in a 400 kb sample: ~90,000 filled reads of
    up to 203 bases on 30 contigs, 3 % of bases N-like."""
    rng = np.random.default_rng(seed)
    cl = rng.integers(4_000, 24_000, 30)
    cl = (cl * 400_000 / cl.sum()).astype(np.int64)
    return _reads(rng, cl, 90_000, 203, overhang=20, n_frac=0.03,
                  ok_frac=0.98)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + ["cell"])
def test_kernel_matches_plain_version(cuda_device, name):
    """The kernel's votes equal the plain version's element for element;
    one launch a segment."""
    if name == "cell":
        arrays, seg = _cell_reads(), 100_000
    else:
        *arrays, seg = _case(name)
    total = int(arrays[0][-1])
    want = tpolish._pileup_votes(*arrays, seg=seg, device="cpu")
    trace.reset("pileup")
    got = tpolish._pileup_votes(*arrays, seg=seg, device=cuda_device)
    torch.cuda.synchronize()
    assert np.array_equal(got, want)
    assert trace.count("pileup") == -(-total // seg)


def _polish_inputs():
    """tests/test_torch_scaffold.py::test_polish's inputs: a contig with
    substitutions and a 1 bp deletion, reads placed gap-free from the
    simulator's truth."""
    g = sim.random_genome(30_000, seed=81)[:12_000]
    contig = g.copy()
    subs = np.arange(500, 11_000, 1500)
    contig[subs] = (contig[subs] + 1) % 4
    x = 6_000
    contig = np.concatenate([contig[:x], contig[x + 1:]])  # 1 bp deletion
    b, _, truth = sim.simulate_paired_reads(g, coverage=30,
                                            error_rate=0.002, seed=86)
    starts = truth.read_starts.astype(np.int64)
    starts = np.where(starts > x, starts - 1, starts)
    ok = (starts >= 0) & (starts + 100 <= len(contig))
    anchor = np.where(truth.read_rc, starts + 99, starts).astype(np.int32)
    al = (np.zeros(len(starts), np.int32), anchor, truth.read_rc, ok)
    offs = np.array([0, len(contig)], np.int64)
    return contig, offs, np.asarray(b.codes), np.asarray(b.lengths), al


@pytest.mark.cuda
def test_polish_on_the_card_matches_the_cpu(cuda_device):
    """polish_contigs and polish_indels give the same bases, offsets and
    counts on the card as on the CPU; each pass launches the kernel once
    (one segment)."""
    contig, offs, codes, lens, al = _polish_inputs()
    trace.reset("pileup")
    cb, cn = tpolish.polish_contigs(contig, offs, codes, lens, *al,
                                    device="cpu")
    assert trace.count("pileup") == 0
    gb, gn = tpolish.polish_contigs(contig, offs, codes, lens, *al,
                                    device=cuda_device)
    assert trace.count("pileup") == 1
    assert cn == gn > 0 and np.array_equal(cb, gb)
    want = tpolish.polish_indels(cb, offs, codes, lens, *al, device="cpu")
    got = tpolish.polish_indels(gb, offs, codes, lens, *al,
                                device=cuda_device)
    assert trace.count("pileup") == 2
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    assert want[2:] == got[2:] and got[2] >= 1

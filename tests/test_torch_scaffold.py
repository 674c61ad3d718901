"""Module parity for the scaffolding and finishing slice: the port vs the
reference on the same numpy inputs, exactly.

ec/jump (flip_reads, error_correct_jumps), scaffold/links, scaffolder and
circular, asm/patch (patch_scaffold_gaps, with negative junctions wide
enough for the general banded DP), asm/polish (substitution and indel
passes), asm/clean_assembly and eval/accuracy (_genome_kmer_table,
evaluate, estimate_insert_stats, base_error_report). The inputs are a
30 kb genome cut into five contigs that overlap, abut or leave a gap,
with reads placed on them from the simulator's truth.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.asm import clean_assembly as rclean  # noqa: E402
from allpathslg_tpu.asm import patch as rpatch  # noqa: E402
from allpathslg_tpu.asm import polish as rpolish  # noqa: E402
from allpathslg_tpu.ec import jump as rjump  # noqa: E402
from allpathslg_tpu.eval import accuracy as racc  # noqa: E402
from allpathslg_tpu.eval import sim as rsim  # noqa: E402
from allpathslg_tpu.kmer import kmerize as rkmerize  # noqa: E402
from allpathslg_tpu.ops import join as rjoin  # noqa: E402
from allpathslg_tpu.scaffold import circular as rcirc  # noqa: E402
from allpathslg_tpu.scaffold import links as rlinks  # noqa: E402
from allpathslg_tpu.scaffold import scaffolder as rscaf  # noqa: E402
from allpathslg_tpu.scaffold.superb import Superb as RSuperb  # noqa: E402
from allpathslg_tpu.utils.intdist import IntDistribution as RDist  # noqa: E402
from allpathslg_tpu_torch.asm import clean_assembly as tclean  # noqa: E402
from allpathslg_tpu_torch.asm import patch as tpatch  # noqa: E402
from allpathslg_tpu_torch.asm import polish as tpolish  # noqa: E402
from allpathslg_tpu_torch.ec import jump as tjump  # noqa: E402
from allpathslg_tpu_torch.eval import accuracy as tacc  # noqa: E402
from allpathslg_tpu_torch.ops import banded as tbanded  # noqa: E402
from allpathslg_tpu_torch.ops import join as tjoin  # noqa: E402
from allpathslg_tpu_torch.scaffold import circular as tcirc  # noqa: E402
from allpathslg_tpu_torch.scaffold import links as tlinks  # noqa: E402
from allpathslg_tpu_torch.scaffold import scaffolder as tscaf  # noqa: E402
from allpathslg_tpu_torch.scaffold.superb import Superb as TSuperb  # noqa: E402
from allpathslg_tpu_torch.utils.intdist import IntDistribution as TDist  # noqa: E402

torch.set_num_threads(2)
G = 30_000
# contig segments of the genome and their orientation: overlaps of 200 and
# 300 bp (negative gaps), a 50 bp gap and two abutting contigs
SEGS = [(0, 6000), (5800, 12000), (12050, 18000), (17700, 24000),
        (24000, 30000)]
FLIPS = [False, True, False, False, True]
GAPS, DEVS = [-200, 50, -300, 0], [30, 20, 30, 20]


def _rc(s):
    return ((3 - s[::-1].astype(np.int64)) % 4).astype(np.uint8)


def _place(starts, rc, L, min_overlap=60):
    """Alignlets of reads with genome footprints [start, start + L) on the
    contigs of SEGS: the contig holding the footprint's midpoint, when at
    least `min_overlap` bases of the read lie in it (reads may hang off a
    contig end, as patching needs); anchor = base 0's contig position."""
    starts = np.asarray(starts, np.int64)
    mid = starts + L // 2
    n = len(starts)
    contig = np.full(n, -1, np.int32)
    anchor = np.zeros(n, np.int32)
    is_rc = np.zeros(n, bool)
    ok = np.zeros(n, bool)
    for k, ((s, e), flip) in enumerate(zip(SEGS, FLIPS)):
        sel = (mid >= s) & (mid < e) & (contig < 0)
        sel &= (np.minimum(starts + L, e) - np.maximum(starts, s)) \
            >= min_overlap
        pos = starts - s
        r = np.asarray(rc, bool).copy()
        if flip:
            pos = (e - s) - pos - L
            r = ~r
        contig[sel] = k
        anchor[sel] = np.where(r, pos + L - 1, pos)[sel]
        is_rc[sel] = r[sel]
        ok[sel] = True
    return contig, anchor, is_rc, ok


@pytest.fixture(scope="module")
def genome():
    return rsim.random_genome(G, seed=81)


@pytest.fixture(scope="module")
def contigs(genome):
    return [_rc(genome[s:e]) if f else genome[s:e].copy()
            for (s, e), f in zip(SEGS, FLIPS)]


@pytest.fixture(scope="module")
def jump_alignlets(genome):
    """A 3000 +- 300 innie library (jump pairs after EC's flip)."""
    b, p, truth = rsim.simulate_paired_reads(
        genome, coverage=20, insert_mean=3000, insert_sd=300,
        error_rate=0.0, seed=82)
    al = _place(truth.read_starts, truth.read_rc, 100)
    return al, np.asarray(b.lengths), np.asarray(p.pairs)


@pytest.fixture(scope="module")
def frag_alignlets(genome):
    b, _, truth = rsim.simulate_paired_reads(genome, coverage=30,
                                             error_rate=0.002, seed=83)
    al = _place(truth.read_starts, truth.read_rc, 100)
    return np.asarray(b.codes), np.asarray(b.lengths), al


def _eq_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name


def _eq_superbs(ra, ta):
    assert [dataclasses.astuple(s) for s in ra] == \
        [dataclasses.astuple(s) for s in ta]


# ---- ec/jump ----------------------------------------------------------------

def test_flip_reads():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, (64, 50)).astype(np.uint8)
    quals = rng.integers(2, 41, (64, 50)).astype(np.uint8)
    lens = rng.integers(0, 51, 64).astype(np.int32)
    rc, rq = rjump.flip_reads(jnp.asarray(codes), jnp.asarray(quals),
                              jnp.asarray(lens))
    tc, tq = tjump.flip_reads(torch.from_numpy(codes),
                              torch.from_numpy(quals),
                              torch.from_numpy(lens))
    assert np.array_equal(np.asarray(rc), tc.numpy())
    assert np.array_equal(np.asarray(rq), tq.numpy())


def test_error_correct_jumps(genome):
    """Trusted-prefix truncation against the genome's 24-mers, the flip
    and the duplicate removal, on outie reads with chimeric tails and
    copied pairs."""
    canon, valid = rkmerize.kmer_windows(jnp.asarray(genome[None, :]), 24)
    rows = np.unique(np.stack([np.asarray(w)[0][np.asarray(valid)[0]]
                               for w in canon], 1), axis=0)
    words = [rows[:, i].astype(np.uint32) for i in range(rows.shape[1])]
    b, p, _ = rsim.simulate_paired_reads(
        genome, coverage=8, insert_mean=3000, insert_sd=300,
        error_rate=0.0, outward=True, seed=84)
    codes = np.asarray(b.codes).copy()
    quals = np.asarray(b.quals)
    lens = np.asarray(b.lengths).copy()
    pairs = np.asarray(p.pairs)
    rng = np.random.default_rng(85)
    chim = rng.random(len(codes)) < 0.2
    cut = rng.integers(20, 90, len(codes))
    tail = np.arange(codes.shape[1])[None, :] >= cut[:, None]
    codes = np.where(chim[:, None] & tail,
                     rng.integers(0, 4, codes.shape), codes).astype(np.uint8)
    dup = rng.choice(len(pairs), 40, replace=False)
    codes[pairs[dup[20:], 0]] = codes[pairs[dup[:20], 0]]
    codes[pairs[dup[20:], 1]] = codes[pairs[dup[:20], 1]]
    lens[:5] = 30                       # too short to keep
    ref = rjump.error_correct_jumps(
        codes, quals, lens, pairs,
        rjoin.hash_table([jnp.asarray(w) for w in words]), batch_size=1024)
    port = tjump.error_correct_jumps(
        codes, quals, lens, pairs,
        tjoin.hash_table([torch.from_numpy(w.astype(np.int64))
                          for w in words]), batch_size=1024, device="cpu")
    for r, t in zip(ref[:4], port[:4]):
        assert r.dtype == t.dtype and np.array_equal(r, t)
    assert ref[4] == port[4]
    assert port[4]["n_duplicates"] > 0
    assert 0 < port[4]["n_pairs_kept"] < port[4]["n_pairs_in"]


# ---- scaffold ---------------------------------------------------------------

def _links(pkg, jump_alignlets):
    (c, a, r, ok), lens, pairs = jump_alignlets
    clens = np.array([e - s for s, e in SEGS], np.int64)
    return pkg.pair_links(c, a, r, ok, lens, pairs, clens,
                          np.array([3000]), np.array([300]),
                          lib_ids=np.zeros(len(pairs), np.int32)), clens


def test_pair_links_and_scaffolds(jump_alignlets):
    """pair_links, make_scaffolds_iterative, remodel_gaps with the
    library's empirical distribution, wrap_pair_counts and tag_circular."""
    (c, a, r, ok), lens, pairs = jump_alignlets
    rlg, clens = _links(rlinks, jump_alignlets)
    tlg, _ = _links(tlinks, jump_alignlets)
    _eq_fields(rlg, tlg)
    rs, rn = rscaf.make_scaffolds_iterative(rlg, len(clens), clens)
    ts, tn = tscaf.make_scaffolds_iterative(tlg, len(clens), clens)
    _eq_superbs(rs, ts)
    assert rn == tn
    assert len(ts) == 1 and len(ts[0].contig_ids) == len(SEGS)
    _, _, hist = racc.estimate_insert_stats(c, a, r, ok, lens, pairs)
    rs = rscaf.remodel_gaps(rs, rlg, [RDist.from_histogram(hist)])
    ts = tscaf.remodel_gaps(ts, tlg, [TDist.from_histogram(hist)])
    _eq_superbs(rs, ts)
    assert min(ts[0].gaps) < 0
    rw = rlinks.wrap_pair_counts(c, a, r, ok, lens, pairs, clens, 3000, 300)
    tw = tlinks.wrap_pair_counts(c, a, r, ok, lens, pairs, clens, 3000, 300)
    assert np.array_equal(rw, tw)
    assert rcirc.tag_circular(rs, rlg, rw) == tcirc.tag_circular(ts, tlg, tw)


# ---- asm/patch --------------------------------------------------------------

def test_patch_scaffold_gaps(contigs, frag_alignlets):
    """Both negative junctions (band 96: the general DP's route) and the
    positive one close; contigs, scaffolds and pieces are identical."""
    codes, lens, (c, a, r, ok) = frag_alignlets
    args = (contigs, codes, lens, c, a, r, ok)
    ref = rpatch.patch_scaffold_gaps(
        [RSuperb(list(range(5)), list(FLIPS), list(GAPS), list(DEVS))], *args)
    calls = []
    orig = tbanded.banded_align_auto

    def logged(*x, band=16, **kw):
        calls.append(band)
        return orig(*x, band=band, **kw)

    tbanded.banded_align_auto = logged
    try:
        port = tpatch.patch_scaffold_gaps(
            [TSuperb(list(range(5)), list(FLIPS), list(GAPS), list(DEVS))],
            *args, device="cpu")
    finally:
        tbanded.banded_align_auto = orig
    assert len(ref[0]) == len(port[0])
    for x, y in zip(ref[0], port[0]):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(x, y)
    _eq_superbs(ref[1], port[1])
    assert ref[2:] == port[2:]
    assert 96 in calls and port[2] >= 2


# ---- asm/polish -------------------------------------------------------------

def test_polish(genome):
    """Substitution and indel passes on contigs carrying substitutions and
    a 1 bp deletion, reads placed gap-free from the truth."""
    g = genome[:12_000]
    contig = g.copy()
    subs = np.arange(500, 11_000, 1500)
    contig[subs] = (contig[subs] + 1) % 4
    x = 6_000
    contig = np.concatenate([contig[:x], contig[x + 1:]])  # 1 bp deletion
    b, _, truth = rsim.simulate_paired_reads(g, coverage=30,
                                             error_rate=0.002, seed=86)
    starts = truth.read_starts.astype(np.int64)
    starts = np.where(starts > x, starts - 1, starts)
    ok = (starts >= 0) & (starts + 100 <= len(contig))
    anchor = np.where(truth.read_rc, starts + 99, starts).astype(np.int32)
    al = (np.zeros(len(starts), np.int32), anchor, truth.read_rc, ok)
    offs = np.array([0, len(contig)], np.int64)
    codes, lens = np.asarray(b.codes), np.asarray(b.lengths)
    rb, rn = rpolish.polish_contigs(contig, offs, codes, lens, *al)
    tb, tn = tpolish.polish_contigs(contig, offs, codes, lens, *al,
                                    device="cpu")
    assert rn == tn > 0 and np.array_equal(rb, tb)
    ref = rpolish.polish_indels(rb, offs, codes, lens, *al)
    port = tpolish.polish_indels(tb, offs, codes, lens, *al, device="cpu")
    assert np.array_equal(ref[0], port[0])
    assert np.array_equal(ref[1], port[1])
    assert ref[2:] == port[2:]
    assert port[2] >= 1


# ---- asm/clean_assembly -----------------------------------------------------

def test_clean_assembly(contigs):
    small = [contigs[0][:100], contigs[2][1000:1300], contigs[3][:50]]
    cs = list(contigs) + small + [contigs[1][500:2500]]
    scaf = [(list(range(5)), list(FLIPS), list(GAPS), list(DEVS)),
            ([5], [False], [], []), ([6, 7], [False, True], [40], [10]),
            ([8], [False], [], [])]
    ref = rclean.clean_assembly(cs, [RSuperb(*map(list, s)) for s in scaf],
                                rclean.CleanConfig())
    port = tclean.clean_assembly(cs, [TSuperb(*map(list, s)) for s in scaf],
                                 tclean.CleanConfig())
    assert len(ref[0]) == len(port[0])
    assert all(np.array_equal(x, y) for x, y in zip(ref[0], port[0]))
    _eq_superbs(ref[1], port[1])
    assert ref[2:] == port[2:]


# ---- eval/accuracy ----------------------------------------------------------

def _flat(cs):
    offs = np.zeros(len(cs) + 1, np.int64)
    np.cumsum([len(c) for c in cs], out=offs[1:])
    return np.concatenate(cs), offs


def test_genome_kmer_table(genome):
    g = genome.copy()
    g[20_000:20_500] = g[3_000:3_500]     # repeated kmers hold position -1
    ref = racc._genome_kmer_table(g, 32)
    port = tacc._genome_kmer_table(g, 32, device="cpu")
    for r, t in zip(ref[0] + [ref[1], ref[2]], port[0] + [port[1], port[2]]):
        assert np.array_equal(np.asarray(r).astype(np.int64),
                              t.numpy().astype(np.int64))
    assert int((port[1] < 0).sum()) > 0


def test_evaluate_and_base_errors(genome, contigs):
    """A chimeric contig (a misassembly break), errors in another, and
    the insert estimate of a library."""
    chim = np.concatenate([genome[2_000:7_000], genome[20_000:25_000]])
    err = contigs[2].copy()
    err[::97] = (err[::97] + 1) % 4
    bases, offs = _flat([contigs[0], contigs[1], err, chim])
    ref = racc.evaluate(bases, offs, genome)
    port = tacc.evaluate(bases, offs, genome, device="cpu")
    assert ref == port and port["misassembly_breaks"] >= 1
    ref = racc.base_error_report(bases, offs, genome, max_windows=24)
    port = tacc.base_error_report(bases, offs, genome, max_windows=24,
                                  device="cpu")
    assert ref == port and port["sub_rate"] > 0


def test_estimate_insert_stats(jump_alignlets):
    (c, a, r, ok), lens, pairs = jump_alignlets
    ref = racc.estimate_insert_stats(c, a, r, ok, lens, pairs)
    port = tacc.estimate_insert_stats(c, a, r, ok, lens, pairs)
    assert ref[:2] == port[:2] and np.array_equal(ref[2], port[2])
    assert abs(port[0] - 3000) < 150

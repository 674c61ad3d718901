"""Port unipath chain (graph/unipath, graph/pathsdb, asm/localize,
graph/cleanup, graph/digraph, asm/fill) vs the reference.

The genome is X R Y R Z with one exact repeat R longer than K and shorter
than the reads (tests/test_pathsdb_localize.py), so read threading has a
junction to split. Both packages count the same reads at K=24, condense
unipaths, path the reads, localize and simplify; every array must be
equal. convert.* carries the reference's state into the port, so each
module is also fed the reference's own inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.asm import fill as rfill  # noqa: E402
from allpathslg_tpu.asm import localize as rloc  # noqa: E402
from allpathslg_tpu.dtypes.reads import batch_from_codes  # noqa: E402
from allpathslg_tpu.eval import sim  # noqa: E402
from allpathslg_tpu.graph import cleanup as rclean  # noqa: E402
from allpathslg_tpu.graph import digraph as rdig  # noqa: E402
from allpathslg_tpu.graph import pathsdb as rpdb  # noqa: E402
from allpathslg_tpu.graph import unipath as rup  # noqa: E402
from allpathslg_tpu.kmer import count as rcount  # noqa: E402
from allpathslg_tpu_torch import convert  # noqa: E402
from allpathslg_tpu_torch.asm import fill as tfill  # noqa: E402
from allpathslg_tpu_torch.asm import localize as tloc  # noqa: E402
from allpathslg_tpu_torch.graph import cleanup as tclean  # noqa: E402
from allpathslg_tpu_torch.graph import digraph as tdig  # noqa: E402
from allpathslg_tpu_torch.graph import pathsdb as tpdb  # noqa: E402
from allpathslg_tpu_torch.graph import unipath as tup  # noqa: E402
from allpathslg_tpu_torch.kmer import count as tcount  # noqa: E402

torch.set_num_threads(2)
K = 24


def _repeat_genome(seed=5, flank=700, rep=120):
    x = sim.random_genome(flank, seed=seed)
    y = sim.random_genome(flank, seed=seed + 1)
    z = sim.random_genome(flank, seed=seed + 2)
    r = sim.random_genome(rep, seed=seed + 3)
    return np.concatenate([x, r, y, r, z])


def _windows_as_reads(genome, L=200, step=11):
    starts = np.arange(0, len(genome) - L + 1, step)
    if starts[-1] != len(genome) - L:
        starts = np.append(starts, len(genome) - L)
    return np.stack([genome[s:s + L] for s in starts])


def _reads(rep=120, L=200, step=11, err_every=0):
    reads = _windows_as_reads(_repeat_genome(rep=rep), L=L, step=step)
    if err_every:        # a few substitutions -> low-count kmers to filter
        reads = reads.copy()
        reads[::err_every, L // 2] = (reads[::err_every, L // 2] + 1) % 4
    return reads


def _build_ref(reads, min_count):
    batch = batch_from_codes(reads, np.full(len(reads), reads.shape[1],
                                            np.int32))
    ck = rcount.trim_to_host(rcount.count_reads(batch.codes, K))
    return ck, rup.build_unipaths(ck.words, K, min_count=min_count,
                                  counts=ck.counts, with_graph=True,
                                  with_placement=True)


def _build_port(reads, min_count):
    ck = tcount.trim_to_host(tcount.count_reads(torch.from_numpy(reads), K))
    return tup.build_unipaths(ck.words, K, min_count=min_count,
                              counts=ck.counts, with_graph=True,
                              with_placement=True, device="cpu")


def _assert_same(a, b, fields, what):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f}")


UPS = ("bases", "offsets", "kmer_counts", "mean_cov")
GRAPH = ("a", "fa", "b", "fb")
PATHS = ("offsets", "uid", "fwd", "enter", "leave", "pos")


@pytest.fixture(scope="module")
def built():
    out = {}
    for name, kw, min_count in (("repeat", {}, 1),
                                ("errors", dict(err_every=9), 2),
                                ("long_repeat", dict(rep=300, L=80,
                                                     step=7), 1)):
        reads = _reads(**kw)
        ck, ref = _build_ref(reads, min_count)
        port = _build_port(reads, min_count)
        out[name] = (reads, ck, ref, port)
    return out


@pytest.mark.parametrize("case", ["repeat", "errors", "long_repeat"])
def test_build_unipaths_matches_reference(built, case):
    _, _, (rups, rg, rpl), (tups, tg, tpl) = built[case]
    assert tups.n == rups.n > 1
    _assert_same(rups, tups, UPS, "unipaths")
    _assert_same(rg, tg, GRAPH, "graph")
    _assert_same(rpl, tpl, ("uid", "upos", "urc"), "placement")
    for wr, wt in zip(rpl.table, tpl.table):
        np.testing.assert_array_equal(np.asarray(wr).astype(np.int64),
                                      wt.numpy())


@pytest.mark.parametrize("case", ["repeat", "long_repeat"])
def test_path_reads_and_pathsdb_match_reference(built, case):
    reads, _, (rups, _, rpl), (_, _, tpl) = built[case]
    want = rpdb.path_reads(rpl, reads, batch_size=64)
    got = tpdb.path_reads(tpl, reads, batch_size=64)
    _assert_same(want, got, PATHS, "read_paths")
    # the reference's placement, converted, paths to the same read paths
    conv = convert.kmer_placement(rpl.K, rpl.table, rpl.uid, rpl.upos,
                                  rpl.urc, device="cpu")
    _assert_same(want, tpdb.path_reads(conv, reads, batch_size=100), PATHS,
                 "read_paths(converted placement)")
    rdb = rpdb.build_pathsdb(want, rups.n)
    tdb = tpdb.build_pathsdb(got, rups.n)
    _assert_same(rdb, tdb, ("offsets", "read", "entry"), "pathsdb")
    for x, y in zip(rpdb.transitions(want), tpdb.transitions(got)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["repeat", "long_repeat"])
def test_localize_and_simplify_match_reference(built, case):
    reads, _, (rups, rg, rpl), _ = built[case]
    rp = rpdb.path_reads(rpl, reads)
    r_ups, r_g, r_m, r_rp = rloc.localize_resolve(rups, rg, rp)
    # the port's copies, fed the reference's state through convert
    t_in = (convert.unipaths(rups.bases, rups.offsets, rups.kmer_counts,
                             rups.mean_cov),
            convert.unigraph(rg.a, rg.fa, rg.b, rg.fb),
            convert.read_paths(rp.offsets, rp.uid, rp.fwd, rp.enter,
                               rp.leave, rp.pos))
    t_ups, t_g, t_m, t_rp = tloc.localize_resolve(*t_in)
    assert r_m == t_m
    if case == "repeat":
        assert t_m["n_repeats_split"] >= 1       # localize does real work
    else:
        assert t_m["n_repeats_split"] == 0
    _assert_same(r_ups, t_ups, UPS, "localized unipaths")
    _assert_same(r_g, t_g, GRAPH, "localized graph")
    _assert_same(r_rp, t_rp, PATHS, "revised read paths")
    r_c, r_cm = rclean.simplify(r_ups, r_g, K, ploidy=1)
    t_c, t_cm = tclean.simplify(t_ups, t_g, K, ploidy=1)
    assert r_cm == t_cm
    assert len(r_c.seqs) == len(t_c.seqs)
    for x, y in zip(r_c.seqs, t_c.seqs):
        np.testing.assert_array_equal(x, y)
    assert repr(r_c.ambiguities) == repr(t_c.ambiguities)
    if case == "repeat":
        assert max(len(s) for s in t_c.seqs) == len(_repeat_genome())


@pytest.mark.parametrize("n,n_edges", [(1, 0), (50, 0), (300, 200),
                                       (1000, 900)])
def test_connected_components_matches_reference(n, n_edges):
    rng = np.random.default_rng(n)
    src = rng.integers(0, n, n_edges).astype(np.int32)
    dst = rng.integers(0, n, n_edges).astype(np.int32)
    rg = rdig.EdgeGraph(n, src, dst)
    tg = tdig.EdgeGraph(n, src, dst)
    want = rdig.connected_components(rg)
    got = tdig.connected_components(tg)
    assert want.dtype == got.dtype
    np.testing.assert_array_equal(want, got)
    for a, b in zip(rdig.components_as_lists(rg),
                    tdig.components_as_lists(tg)):
        np.testing.assert_array_equal(a, b)


def test_fill_pairs_matches_reference():
    genome = sim.random_genome(20_000, seed=3)
    batch, pairs, _ = sim.simulate_paired_reads(
        genome, coverage=10, error_rate=0.004, insert_mean=180,
        insert_sd=30, seed=4)
    p = np.asarray(pairs.pairs)
    codes, quals = np.asarray(batch.codes), np.asarray(batch.quals)
    lens = np.asarray(batch.lengths).copy()
    lens[::7] -= 13                       # ragged lengths
    cfg = rfill.FillConfig()
    args = [codes[p[:, 0]], quals[p[:, 0]], lens[p[:, 0]],
            codes[p[:, 1]], quals[p[:, 1]], lens[p[:, 1]]]
    want = rfill.fill_pairs(*(jnp.asarray(a) for a in args), cfg, 260)
    got = tfill.fill_pairs(*(torch.from_numpy(a) for a in args),
                           tfill.FillConfig(), 260)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(w, g.numpy())
    assert 0.3 < got[3].float().mean() < 0.95

"""The port's LongProto family == the reference's.

Friend finding and friend-stack correction (long/friends.py), the
supported graph (long/supported.py, fed the reference's own unipaths, graph
and read paths through convert.py) and long_proto end to end on the
genomes of the reference's tests/test_longproto.py, the pull-apart repeats
included: the same records, corrections, contigs and metrics.

The reference sorts its (k-mer, read) keys unstably (`lax.sort(...,
is_stable=False)`, long/friends.py:67-69); the port sorts them stably. The
two agree except where a read holds one 16-mer twice (ROADMAP Queue 3):
there the port equals the reference with that one sort made stable, and
the sorted tuples differ only in the order of those ties.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from allpathslg_tpu.eval import sim  # noqa: E402
from allpathslg_tpu.graph import pathsdb as r_pathsdb  # noqa: E402
from allpathslg_tpu.graph import unipath as r_unipath  # noqa: E402
from allpathslg_tpu.kmer import count as r_count  # noqa: E402
from allpathslg_tpu.long import friends as r_fr  # noqa: E402
from allpathslg_tpu.long import longproto as r_lp  # noqa: E402
from allpathslg_tpu.long import supported as r_sup  # noqa: E402
from allpathslg_tpu_torch import convert  # noqa: E402
from allpathslg_tpu_torch.long import friends as t_fr  # noqa: E402
from allpathslg_tpu_torch.long import longproto as t_lp  # noqa: E402
from allpathslg_tpu_torch.long import supported as t_sup  # noqa: E402

torch.set_num_threads(2)
FIELDS = ("a", "b", "rc", "offset", "shared")


def _sim_batch(G=4000, coverage=25, read_len=250, error_rate=0.0, seed=5):
    """tests/test_longproto.py's _sim_batch."""
    g = sim.random_genome(G, seed=seed)
    batch, _, truth = sim.simulate_paired_reads(
        g, coverage=coverage, read_len=read_len,
        insert_mean=2 * read_len + 50, insert_sd=20,
        error_rate=error_rate, seed=seed + 1)
    return g, np.asarray(batch.codes), truth


def _repeat_16mer_reads():
    """Reads that hold one 16-mer (and its reverse complement) more than
    once: a unit planted every 150 bp, again 60 bp later and reverse-
    complemented 100 bp later."""
    rng = np.random.default_rng(0)
    unit = rng.integers(0, 4, 16).astype(np.uint8)
    g = sim.random_genome(2000, seed=9)
    for at in range(100, 1900, 150):
        g[at:at + 16] = unit
        if at + 80 < 2000:
            g[at + 60:at + 76] = unit
        if at + 120 < 2000:
            g[at + 100:at + 116] = 3 - unit[::-1]
    b, _, _ = sim.simulate_paired_reads(g, coverage=20, read_len=250,
                                        insert_mean=550, insert_sd=20,
                                        error_rate=0.005, seed=3)
    return np.asarray(b.codes)


def _same_friends(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _stable_reference(monkeypatch):
    orig = lax.sort
    monkeypatch.setattr(lax, "sort", lambda *a, **kw: orig(
        *a, **{**kw, "is_stable": True}))


@pytest.mark.parametrize("case", [
    dict(G=2000, coverage=15, error_rate=0.0, seed=5, min_shared=4),
    dict(G=2000, coverage=30, error_rate=0.01, seed=11, min_shared=4),
    dict(G=2500, coverage=20, error_rate=0.004, seed=7, min_shared=3),
], ids=["exact", "errors", "k3"])
def test_friends_and_correction_equal_the_reference(case):
    min_shared = case.pop("min_shared")
    _, codes, _ = _sim_batch(**case)
    f_r = r_fr.find_friends(codes, K=16, min_shared=min_shared)
    f_t = t_fr.find_friends(codes, K=16, min_shared=min_shared,
                            device="cpu")
    _same_friends(f_r, f_t)
    assert len(f_t.a) > 0
    c_r, n_r = r_fr.correct_with_friends(codes, f_r)
    c_t, n_t = t_fr.correct_with_friends(
        codes, convert.friends(*(getattr(f_r, k) for k in FIELDS)))
    assert n_r == n_t and np.array_equal(c_r, c_t)


def test_friends_repeated_16mer_equals_the_stable_reference(monkeypatch):
    codes = _repeat_16mer_reads()
    f_t = t_fr.find_friends(codes, K=16, min_shared=3, device="cpu")
    _stable_reference(monkeypatch)
    f_r = r_fr.find_friends(codes, K=16, min_shared=3)
    _same_friends(f_r, f_t)
    c_r, n_r = r_fr.correct_with_friends(codes, f_r)
    c_t, n_t = t_fr.correct_with_friends(codes, f_t)
    assert n_r == n_t > 0 and np.array_equal(c_r, c_t)


def test_friends_repeated_16mer_ties_only(monkeypatch):
    """Against the reference's unstable sort itself: the same sorted
    (kmer, read) keys and runs; within a tie (one read holding a k-mer
    twice) the same positions, the port's in ascending order."""
    codes = _repeat_16mer_reads()
    r = [np.asarray(x) for x in r_fr._kmer_read_pos(jnp.asarray(codes), 16)]
    t = [x.numpy() for x in t_fr._kmer_read_pos(torch.from_numpy(codes), 16)]
    read_r, pos_r, rc_r, starts_r, sent_r = r
    read_t, pos_t, rc_t, starts_t, sent_t = t
    assert np.array_equal(read_r, read_t)
    assert np.array_equal(starts_r, starts_t)
    assert np.array_equal(sent_r, sent_t)
    run = np.cumsum(starts_t)
    key = (run.astype(np.int64) << 32) | read_t
    group = np.concatenate([[0], np.cumsum(key[1:] != key[:-1])])
    tie = np.bincount(group)[group] > 1
    assert tie.sum() > 0
    assert np.array_equal(pos_r[~tie], pos_t[~tie])
    assert np.array_equal(rc_r[~tie], rc_t[~tie])
    for arr_r, arr_t in ((pos_r, pos_t), (rc_r, rc_t)):
        o_r = np.lexsort((pos_r, arr_r, group))
        o_t = np.lexsort((pos_t, arr_t, group))
        assert np.array_equal(arr_r[o_r], arr_t[o_t])
    g = group[tie]
    assert (np.diff(pos_t[tie])[g[1:] == g[:-1]] > 0).all()


def _reference_graph(codes, K):
    ck = r_count.trim_to_host(r_count.count_reads_streaming(codes, K))
    ups, g, placement = r_unipath.build_unipaths(
        [jnp.asarray(w) for w in ck.words], K, min_count=2,
        counts=np.asarray(ck.counts), with_graph=True, with_placement=True)
    return ups, g, r_pathsdb.path_reads(placement, codes)


def _port_state(ups, g, rp):
    return (convert.unipaths(ups.bases, ups.offsets, ups.kmer_counts,
                             ups.mean_cov),
            convert.unigraph(g.a, g.fa, g.b, g.fb),
            convert.read_paths(rp.offsets, rp.uid, rp.fwd, rp.enter,
                               rp.leave, rp.pos))


def _same_sg(sg_r, sg_t):
    for k in ("edge_support", "node_cov"):
        x, y = getattr(sg_r, k), getattr(sg_t, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    for k in ("a", "fa", "b", "fb"):
        assert np.array_equal(getattr(sg_r.g, k), getattr(sg_t.g, k)), k
    for k in ("bases", "offsets", "kmer_counts"):
        assert np.array_equal(getattr(sg_r.ups, k), getattr(sg_t.ups, k)), k


def _three_copy_repeat():
    """tests/test_longproto.py's three-way pull-apart genome and reads."""
    rng = np.random.default_rng(3)
    u1, rep, u2, u3, u4, u5, u6 = (rng.integers(0, 4, n).astype(np.uint8)
                                   for n in (400, 60, 400, 400, 400, 400,
                                             400))
    genome = np.concatenate([u1, rep, u2, u3, rep, u4, u5, rep, u6])
    batch, _, _ = sim.simulate_paired_reads(
        genome, coverage=40, read_len=200, insert_mean=450, insert_sd=20,
        error_rate=0.0, seed=4)
    return genome, np.asarray(batch.codes)


def test_supported_graph_equals_the_reference():
    _, codes = _three_copy_repeat()
    K = 32
    ups, g, rp = _reference_graph(codes, K)
    sg_r = r_sup.build_supported(ups, g, rp)
    t_ups, t_g, t_rp = _port_state(ups, g, rp)
    sg_t = t_sup.build_supported(t_ups, t_g, t_rp)
    _same_sg(sg_r, sg_t)
    out_r = r_sup.simplify_supported(sg_r, rp, 2, 2, ploidy=1, K=K)
    out_t = t_sup.simplify_supported(sg_t, t_rp, 2, 2, ploidy=1, K=K)
    _same_sg(out_r[0], out_t[0])
    assert out_r[1] == out_t[1] and out_t[1]["n_pulled_apart"] >= 2
    for k in ("offsets", "uid", "fwd", "enter", "leave", "pos"):
        assert np.array_equal(getattr(out_r[2], k), getattr(out_t[2], k)), k


@pytest.mark.parametrize("ploidy,ratio", [(1, 3.0), (2, 3.0), (1, 1.5)])
def test_bubble_resolution_equals_the_reference(ploidy, ratio):
    """tests/test_longproto.py::test_path_supported_bubble_resolution's
    graph, with both supports of its two cases."""
    for es in ([1, 9, 1, 9], [5, 6, 5, 6]):
        out = []
        for ups_cls, g_cls, sup in ((r_unipath.Unipaths, r_unipath.UniGraph,
                                     r_sup),
                                    (None, None, t_sup)):
            bases = np.zeros(60, np.uint8)
            offsets = np.arange(0, 70, 10, np.int64)
            kc = np.full(6, 5, np.int32)
            a, b = np.array([0, 0, 1, 2], np.int32), np.array([1, 2, 3, 3],
                                                              np.int32)
            fa, fb = np.ones(4, bool), np.ones(4, bool)
            if ups_cls is None:
                ups = convert.unipaths(bases, offsets, kc)
                g = convert.unigraph(a, fa, b, fb)
                sg = convert.supported_graph(ups, g, np.array(es, np.int32),
                                             np.ones(6, np.int32))
            else:
                sg = sup.SupportedGraph(
                    ups=ups_cls(bases=bases, offsets=offsets, kmer_counts=kc),
                    g=g_cls(a=a, fa=fa, b=b, fb=fb),
                    edge_support=np.array(es, np.int32),
                    node_cov=np.ones(6, np.int32))
            out.append(sup.resolve_bubbles_by_paths(sg, None, min_ratio=ratio,
                                                    ploidy=ploidy))
        (sg_r, n_r), (sg_t, n_t) = out
        assert n_r == n_t
        _same_sg(sg_r, sg_t)


def _pull_apart_one():
    rng = np.random.default_rng(3)
    u1, rep, u2, u3, u4 = (rng.integers(0, 4, n).astype(np.uint8)
                           for n in (400, 60, 400, 400, 400))
    genome = np.concatenate([u1, rep, u2, u3, rep, u4])
    batch, _, _ = sim.simulate_paired_reads(
        genome, coverage=40, read_len=200, insert_mean=450, insert_sd=20,
        error_rate=0.0, seed=4)
    return genome, np.asarray(batch.codes)


@pytest.mark.parametrize("case", ["reconstruct", "pull_apart",
                                  "three_way_pull_apart"])
def test_long_proto_equals_the_reference(case):
    """tests/test_longproto.py's three long_proto genomes."""
    if case == "reconstruct":
        genome, codes, _ = _sim_batch(G=3000, coverage=30, error_rate=0.004,
                                      seed=7)
        kw = dict(K=48, ploidy=1)
    else:
        genome, codes = (_pull_apart_one() if case == "pull_apart"
                         else _three_copy_repeat())
        kw = dict(K=32, correction_rounds=0, ploidy=1, min_kmer_count=2)
    res_r = r_lp.long_proto(codes, r_lp.LongProtoConfig(**kw))
    res_t = t_lp.long_proto(codes, t_lp.LongProtoConfig(**kw), device="cpu")
    assert res_r.metrics == res_t.metrics
    assert len(res_r.contigs.seqs) == len(res_t.contigs.seqs)
    for x, y in zip(res_r.contigs.seqs, res_t.contigs.seqs):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert res_r.contigs.ambiguities == res_t.contigs.ambiguities
    _same_sg(res_r.sg, res_t.sg)
    best = max(res_t.contigs.seqs, key=len)
    assert len(best) > 0.85 * len(genome)

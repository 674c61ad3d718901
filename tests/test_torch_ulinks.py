"""Port unipath link graph (graph/ulinks.py, native/radix_sort.cpp) vs the
reference.

tests/test_ulinks.py's three genomes go through both packages end to end
(count, unipaths, placements, read paths, links, neighbourhoods) on the
same simulated reads: read paths, every link array (sep and dev float32
bit for bit) and the neighbourhoods must be equal. A synthetic read-path
set with more than 2**14 cross pairs sends the link keys through the
native radix sort, not numpy's argsort; and a failed g++ build raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.dtypes.reads import batch_from_codes  # noqa: E402
from allpathslg_tpu.eval import sim  # noqa: E402
from allpathslg_tpu.graph import pathsdb as r_pathsdb  # noqa: E402
from allpathslg_tpu.graph import ulinks as r_ulinks  # noqa: E402
from allpathslg_tpu.graph import unipath as r_unipath  # noqa: E402
from allpathslg_tpu.kmer import count as r_count  # noqa: E402
from allpathslg_tpu_torch import convert  # noqa: E402
from allpathslg_tpu_torch.graph import pathsdb as t_pathsdb  # noqa: E402
from allpathslg_tpu_torch.graph import ulinks as t_ulinks  # noqa: E402
from allpathslg_tpu_torch.graph import unipath as t_unipath  # noqa: E402
from allpathslg_tpu_torch.kmer import count as t_count  # noqa: E402
from allpathslg_tpu_torch.native import build as t_build  # noqa: E402

torch.set_num_threads(2)
K = 24
LINK_FIELDS = ("a", "fla", "b", "flb", "n_pairs", "sep", "dev")
PATH_FIELDS = ("offsets", "uid", "fwd", "enter", "leave", "pos")


def _tiles(genome, L=60, step=7):
    starts = np.arange(0, len(genome) - L + 1, step)
    if starts[-1] != len(genome) - L:
        starts = np.append(starts, len(genome) - L)
    return np.stack([genome[s:s + L] for s in starts])


def _same(x, y, fields):
    for f in fields:
        a, b = getattr(x, f), getattr(y, f)
        assert a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f


def _both_graphs(genome, coverage, read_len, insert, sd, seed):
    """Both packages from the same tiles and pairs: (reference link graph,
    port link graph, port unipaths)."""
    tiles = _tiles(genome)
    batch = batch_from_codes(tiles, np.full(len(tiles), 60, np.int32))
    ck = r_count.trim_to_host(r_count.count_reads(batch.codes, K))
    ups_r, _, pl_r = r_unipath.build_unipaths(
        ck.words, K, min_count=1, counts=ck.counts, with_graph=True,
        with_placement=True)
    tck = t_count.trim_to_host(
        t_count.count_reads(torch.from_numpy(tiles), K))
    ups_t, _, pl_t = t_unipath.build_unipaths(
        tck.words, K, min_count=1, counts=tck.counts, with_graph=True,
        with_placement=True, device="cpu")
    assert np.array_equal(ups_r.bases, ups_t.bases)
    pb, pairs, _ = sim.simulate_paired_reads(
        genome, coverage=coverage, read_len=read_len, insert_mean=insert,
        insert_sd=sd, error_rate=0.0, seed=seed)
    codes = np.asarray(pb.codes)
    rp_r = r_pathsdb.path_reads(pl_r, codes)
    rp_t = t_pathsdb.path_reads(pl_t, codes)
    _same(rp_r, rp_t, PATH_FIELDS)
    pairs = np.asarray(pairs.pairs)
    lg_r = r_ulinks.build_ulink_graph(rp_r, pairs, ups_r.kmer_counts, K,
                                      insert, sd)
    lg_t = t_ulinks.build_ulink_graph(rp_t, pairs, ups_t.kmer_counts, K,
                                      insert, sd)
    _same(lg_r, lg_t, LINK_FIELDS)
    return lg_r, lg_t, ups_t


def _same_nhoods(lg_r, lg_t, seeds, **kw):
    nr = r_ulinks.neighborhoods(lg_r, seeds, **kw)
    nt = t_ulinks.neighborhoods(lg_t, seeds, **kw)
    assert len(nr) == len(nt) == len(seeds)
    for x, y in zip(nr, nt):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    return nt


def test_links_across_a_repeat():
    arm1 = sim.random_genome(2500, seed=1)
    arm2 = sim.random_genome(2500, seed=2)
    rep = sim.random_genome(150, seed=3)
    g = np.concatenate([arm1, rep, arm2, rep, sim.random_genome(2500, seed=4)])
    lg_r, lg_t, _ = _both_graphs(g, 30, 80, 900, 10, 5)
    assert lg_t.n_edges >= 1 and (lg_t.sep < 900).all()
    _same_nhoods(lg_r, lg_t, np.unique(lg_t.a), max_sep=5000)


def test_no_links_without_cross_pairs():
    g = sim.random_genome(4000, seed=9)
    lg_r, lg_t, ups = _both_graphs(g, 20, 70, 300, 20, 10)
    assert ups.n == 1 and lg_t.n_edges == 0


def test_neighborhoods_recruit_linked_unipaths():
    g = np.concatenate([sim.random_genome(1500, seed=21),
                        sim.random_genome(200, seed=22),
                        sim.random_genome(1500, seed=23),
                        sim.random_genome(200, seed=22),
                        sim.random_genome(1500, seed=24)])
    lg_r, lg_t, ups = _both_graphs(g, 40, 80, 700, 15, 25)
    assert lg_t.n_edges > 0
    nh = _same_nhoods(lg_r, lg_t, np.arange(ups.n), max_sep=5000)
    assert len(nh[0]) >= 2
    _same_nhoods(lg_r, lg_t, np.arange(ups.n), max_sep=300, max_size=2)


def _synthetic_paths(n_pairs, n_uni, seed):
    """Reads of 0-3 path entries on n_uni unipaths and innie pairs of
    consecutive reads: nearly every pair with two placements crosses."""
    rng = np.random.default_rng(seed)
    n = 2 * n_pairs
    cnt = rng.choice(4, n, p=[0.05, 0.65, 0.2, 0.1])
    offsets = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    T = int(offsets[-1])
    uni_kmers = rng.integers(50, 3000, n_uni).astype(np.int32)
    uid = rng.integers(0, n_uni, T).astype(np.int32)
    pos = (rng.random(T) * (uni_kmers[uid] - 1)).astype(np.int32)
    fields = dict(offsets=offsets, uid=uid, fwd=rng.random(T) < 0.5,
                  enter=rng.integers(0, 60, T).astype(np.int32),
                  leave=rng.integers(60, 80, T).astype(np.int32), pos=pos)
    pairs = np.stack([np.arange(0, n, 2), np.arange(1, n, 2)],
                     1).astype(np.int32)
    cn = rng.choice(3, n_uni, p=[0.1, 0.8, 0.1]).astype(np.int32)
    return fields, pairs, uni_kmers, cn


@pytest.mark.parametrize("with_cn", [False, True], ids=["all", "cn1"])
def test_native_sort_path_equals_reference(monkeypatch, with_cn):
    fields, pairs, uni_kmers, cn = _synthetic_paths(30_000, 60, 3)
    rp_r = r_pathsdb.ReadPaths(**fields)
    rp_t = convert.read_paths(**fields)
    loads = []
    orig = t_build.radix_lib

    def spy():
        loads.append(1)
        return orig()

    monkeypatch.setattr(t_build, "radix_lib", spy)
    seen = []
    orig_sort = t_ulinks.sort_u64_with_payload

    def count_keys(keys, payload):
        seen.append(len(keys))
        return orig_sort(keys, payload)

    monkeypatch.setattr(t_ulinks, "sort_u64_with_payload", count_keys)
    kw = dict(cn=cn) if with_cn else {}
    lg_r = r_ulinks.build_ulink_graph(rp_r, pairs, uni_kmers, K, 3000.0,
                                      300.0, **kw)
    lg_t = t_ulinks.build_ulink_graph(rp_t, pairs, uni_kmers, K, 3000.0,
                                      300.0, **kw)
    assert seen and seen[0] >= t_build.NATIVE_SORT_MIN and loads
    _same(lg_r, lg_t, LINK_FIELDS)
    assert lg_t.n_edges > 100
    seeds = np.unique(lg_t.a)[:20]
    _same_nhoods(lg_r, lg_t, seeds, max_sep=4000, max_size=16)


def test_native_sort_equals_stable_argsort():
    rng = np.random.default_rng(1)
    for n in (t_build.NATIVE_SORT_MIN - 1, t_build.NATIVE_SORT_MIN, 70_000):
        keys = rng.integers(0, 1 << 20, n).astype(np.uint64) << np.uint64(30)
        keys[::5] = keys[0]
        keys[1::9] = np.uint64(1 << 63)
        order = np.argsort(keys, kind="stable")
        ks, ps = t_build.sort_u64_with_payload(keys.copy(),
                                               np.arange(n, dtype=np.int64))
        assert np.array_equal(ks, keys[order]) and np.array_equal(ps, order)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(t_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_build.radix_lib, "lib", None)
    monkeypatch.setattr(t_build, "CXX_FLAGS",
                        t_build.CXX_FLAGS + ["-fno-such-flag-exists"])
    n = t_build.NATIVE_SORT_MIN
    keys = np.arange(n, 0, -1).astype(np.uint64)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_build.sort_u64_with_payload(keys, np.arange(n, dtype=np.int64))
    # below the native sort's size the reference sorts with numpy
    ks, ps = t_build.sort_u64_with_payload(keys[:100].copy(),
                                           np.arange(100, dtype=np.int64))
    assert np.array_equal(ks, np.sort(keys[:100]))
    assert not list(tmp_path.glob("*.so"))

"""The port's parallel/* == the reference's, on the same numpy inputs.

The reference runs on the conftest's 8 virtual CPU devices (a mesh of the
first 3 or all 8); the port on a CPU mesh of as many shards (every sort
through the plain version of the radix sort). Every output is compared
exactly: the spectra, `dropped`, the per-shard table words, counts and
n_unique of distributed_spectrum, the merged tables of the streaming
counters (with and without quals, resident in modes none / raw /
palette), the K=96 table through the sample sort, sample_sort's arrays
(payload order included, the sorts being stable), the ring scan and the
unipath chain sums. Under overflow only the drop counts are compared:
the reference's overflow writes collide at slot 0 (ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.dtypes import devcache as rdevcache  # noqa: E402
from allpathslg_tpu.graph import unipath as runipath  # noqa: E402
from allpathslg_tpu.ops import segmented as rseg  # noqa: E402
from allpathslg_tpu.parallel import dist_count as rdist  # noqa: E402
from allpathslg_tpu.parallel import mesh as rmesh  # noqa: E402
from allpathslg_tpu.parallel import ring as rring  # noqa: E402
from allpathslg_tpu.parallel import sample_sort as rss  # noqa: E402
from allpathslg_tpu_torch.dtypes import devcache as tdevcache  # noqa: E402
from allpathslg_tpu_torch.graph import unipath as tunipath  # noqa: E402
from allpathslg_tpu_torch.ops import segmented as tseg  # noqa: E402
from allpathslg_tpu_torch.parallel import dist_count as tdist  # noqa: E402
from allpathslg_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from allpathslg_tpu_torch.parallel import ring as tring  # noqa: E402
from allpathslg_tpu_torch.parallel import sample_sort as tss  # noqa: E402

torch.set_num_threads(2)
SIZES = [3, 8]


def meshes(n):
    return rmesh.make_mesh(n), tmesh.make_mesh(n, device="cpu")


@pytest.fixture
def jitted_sample_sort(monkeypatch):
    """The reference's sample_sort under jax.jit (eager shard_map takes
    ~20 s a call on the CPU); table_via_sample_sort imports it per call."""
    monkeypatch.setattr(rss, "sample_sort",
                        jax.jit(rss.sample_sort, static_argnums=(0,),
                                static_argnames=("oversample",
                                                 "capacity_factor")))


def np_(x):
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def same(a, b, what):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert (a.astype(np.int64) == b.astype(np.int64)).all(), what


def same_table(r, t, what):
    """Two CountedKmers, trimmed to n_unique, equal."""
    m = int(r.n_unique)
    assert int(t.n_unique) == m, (what, int(r.n_unique), int(t.n_unique))
    for i, (a, b) in enumerate(zip(r.words, t.words)):
        same(np_(a)[:m], np_(b)[:m], f"{what} word {i}")
    same(np_(r.counts)[:m], np_(t.counts)[:m], f"{what} counts")
    assert (r.qsum is None) == (t.qsum is None), what
    if r.qsum is not None:
        same(np_(r.qsum)[:m], np_(t.qsum)[:m], f"{what} qsum")


def reads(seed, n, L, n_frac=0.0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    if n_frac:
        codes[rng.random(codes.shape) < n_frac] = 4
    return codes


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("K", [24, 96])
def test_distributed_spectrum(n, K):
    codes = reads(0, 48, 120, 0.01)
    rm, tm = meshes(n)
    r = jax.jit(lambda c: rdist.distributed_spectrum(
        rm, c, K, capacity_factor=4.0, max_freq=63))(jnp.asarray(codes))
    t = tdist.distributed_spectrum(tm, codes, K, capacity_factor=4.0,
                                   max_freq=63)
    same(r[0], t[0], "spectrum")
    assert int(r[1]) == int(t[1]) == 0
    for i, (a, b) in enumerate(zip(r[2], t[2])):
        same(a, b, f"table word {i}")
    same(r[3], t[3], "table counts")
    same(r[4], t[4], "n_unique per shard")
    assert int(np_(t[4]).sum()) == int(np_(t[0]).sum())


@pytest.mark.parametrize("n", SIZES)
def test_distributed_spectrum_drops_under_small_capacity(n):
    codes = reads(1, 48, 60)
    rm, tm = meshes(n)
    r = jax.jit(lambda c: rdist.distributed_spectrum(
        rm, c, 24, capacity_factor=0.05, max_freq=63))(jnp.asarray(codes))
    t = tdist.distributed_spectrum(tm, codes, 24, capacity_factor=0.05,
                                   max_freq=63)
    assert int(r[1]) > 0
    assert int(r[1]) == int(t[1])
    same(r[0], t[0], "spectrum under overflow")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("with_quals", [False, True])
def test_count_reads_streaming_dist(n, with_quals):
    rng = np.random.default_rng(2)
    codes = reads(2, 300, 60, 0.01)
    quals = rng.integers(2, 40, codes.shape).astype(np.uint8) \
        if with_quals else None
    rm, tm = meshes(n)
    kw = dict(batch_size=96, min_count=2, min_qsum=30 if with_quals else 0,
              spectrum_max_freq=63)
    r, rspec = rdist.count_reads_streaming_dist(
        rm, codes, 25, quals=quals, **kw)
    t, tspec = tdist.count_reads_streaming_dist(
        tm, codes, 25, quals=quals, **kw)
    same_table(r, t, "streamed table")
    same(rspec, tspec, "spectrum")
    assert rdist.count_reads_streaming_dist.last_ici_bytes == \
        tdist.count_reads_streaming_dist.last_ici_bytes


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", ["none", "raw", "palette"])
def test_count_resident_streaming_dist(n, mode):
    rng = np.random.default_rng(3)
    codes = reads(3, 200, 50, 0.01)
    quals = None
    if mode == "raw":       # > 16 distinct values: the raw matrix
        quals = rng.integers(2, 41, codes.shape).astype(np.uint8)
    elif mode == "palette":
        quals = rng.choice(np.array([2, 10, 20, 30, 38], np.uint8),
                           codes.shape)
    rdb = rdevcache.DeviceBatches.from_host(codes, quals, 48)
    tdb = tdevcache.DeviceBatches.from_host(codes, quals, 48, device="cpu")
    if mode == "palette":
        assert tdb.qnib[0] is not None
    elif mode == "raw":
        assert tdb.qnib[0] is None and tdb.qpal[0] is not None
    rm, tm = meshes(n)
    kw = dict(min_count=2, min_qsum=25 if quals is not None else 0)
    r = rdist.count_resident_streaming_dist(rm, rdb, 24, **kw)
    t = tdist.count_resident_streaming_dist(tm, tdb, 24, **kw)
    same_table(r, t, f"resident table ({mode})")
    assert rdist.count_resident_streaming_dist.last_ici_bytes == \
        tdist.count_resident_streaming_dist.last_ici_bytes


def test_count_resident_streaming_dist_batch_not_divisible():
    codes = reads(4, 40, 50)
    tdb = tdevcache.DeviceBatches.from_host(codes, None, 20, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        tdist.count_resident_streaming_dist(tmesh.make_mesh(3, "cpu"), tdb,
                                            24)


@pytest.mark.parametrize("n", SIZES)
def test_table_via_sample_sort(n, jitted_sample_sort):
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 2000).astype(np.uint8)
    starts = rng.integers(0, len(g) - 150, 200)
    codes = np.stack([g[s:s + 150] for s in starts])
    codes[rng.random(codes.shape) < 0.002] = 4
    rm, tm = meshes(n)
    r = rdist.table_via_sample_sort(rm, codes, 96, batch_size=120,
                                    min_count=2)
    t = tdist.table_via_sample_sort(tm, codes, 96, batch_size=120,
                                    min_count=2)
    assert int(r.n_unique) > 0
    same_table(r, t, "K=96 table")


def sort_inputs(case, total):
    rng = np.random.default_rng(6)
    if case == "uniform":
        hi = rng.integers(0, 1 << 16, total).astype(np.uint32)
        lo = rng.integers(0, 1 << 32, total, dtype=np.uint64).astype(
            np.uint32)
    elif case == "skewed":      # 70 % one key word: the splitters collide
        hi = np.where(rng.random(total) < 0.7, 42,
                      rng.integers(0, 1 << 20, total)).astype(np.uint32)
        lo = rng.integers(0, 1 << 4, total).astype(np.uint32)
    else:                       # one key: a single bucket overflows
        hi = np.zeros(total, np.uint32)
        lo = np.zeros(total, np.uint32)
    hi[rng.random(total) < 0.01] = 0xFFFFFFFF       # a few sentinel words
    return hi, lo, np.arange(total, dtype=np.int32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case,factor", [("uniform", 2.0), ("skewed", 4.0),
                                         ("overflow", 0.5)])
def test_sample_sort(n, case, factor):
    hi, lo, pay = sort_inputs(case, 24 * 512)
    rm, tm = meshes(n)
    sh = rmesh.sharded(rm)
    rw, rp, rn, rdrop = jax.jit(lambda a, b, p: rss.sample_sort(
        rm, [a, b], [p], capacity_factor=factor))(
        *[jax.device_put(jnp.asarray(a), sh) for a in (hi, lo, pay)])
    tw, tp, tn, tdrop = tss.sample_sort(tm, [hi, lo], [pay],
                                        capacity_factor=factor)
    assert int(rdrop) == int(tdrop)
    if case == "overflow":
        assert tdrop > 0
        assert int(np_(tn).sum()) + tdrop == len(hi) - int(
            ((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF)).sum())
        return
    assert tdrop == 0
    for i, (a, b) in enumerate(zip(rw, tw)):
        same(a, b, f"sorted word {i}")
    same(rp[0], tp[0], "payload")
    same(rn, tn, "n_real per shard")
    # stripped of sentinels in shard order: the global stable sort
    w0, w1, p = np_(tw[0]), np_(tw[1]), np_(tp[0])
    keep = ~((w0 == 0xFFFFFFFF) & (w1 == 0xFFFFFFFF))
    order = np.lexsort((pay, lo, hi))
    order = order[~((hi[order] == 0xFFFFFFFF) & (lo[order] == 0xFFFFFFFF))]
    assert (p[keep] == order).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", ["sparse", "dense", "no_start_shards",
                                  "head_open"])
def test_ring_segmented_cumsum(n, case):
    rng = np.random.default_rng(7)
    T = n * 1000
    values = rng.integers(0, 10, T).astype(np.int32)
    starts = rng.random(T) < (0.002 if case == "sparse" else 0.05)
    starts[0] = True
    if case == "no_start_shards":   # runs crossing whole shards
        starts[:] = False
        starts[0] = True
        starts[T // 2 + 7] = True
    if case == "head_open":         # the implicit start of shard 0
        starts[0] = False
    rm, tm = meshes(n)
    r = jax.jit(lambda v, s: rring.ring_segmented_cumsum(rm, v, s))(
        jnp.asarray(values), jnp.asarray(starts))
    t = tring.ring_segmented_cumsum(tm, values, starts)
    same(r, t, "ring scan")
    want = rseg.segment_cumsum(jnp.asarray(values), jnp.asarray(starts))
    same(want, tseg.segment_cumsum(torch.from_numpy(values),
                                   torch.from_numpy(starts)), "one shard")
    same(want, t, "ring == one-shard scan")


@pytest.mark.parametrize("T,first", [(1000, True), (1000, False), (1, False),
                                     (7, True)])
def test_segment_cumsum(T, first):
    """Elements before the first start sum from position 0; int32 wraps
    as the reference's does."""
    rng = np.random.default_rng(T)
    values = rng.integers(-2**31, 2**31 - 1, T).astype(np.int32)
    starts = rng.random(T) < 0.05
    starts[0] = first
    r = rseg.segment_cumsum(jnp.asarray(values), jnp.asarray(starts))
    t = tseg.segment_cumsum(torch.from_numpy(values),
                            torch.from_numpy(starts))
    assert t.dtype == torch.int32
    same(r, t, "segment_cumsum")


@pytest.mark.parametrize("n", SIZES)
def test_chain_sums_ring(n):
    rng = np.random.default_rng(11)
    T = 1003                        # not divisible by the mesh: padding
    counts = rng.integers(1, 255, T).astype(np.int64)
    starts = rng.random(T) < 0.03
    starts[0] = True
    rm, tm = meshes(n)
    r = runipath._chain_sums_ring(rm, counts, starts)
    t = tunipath._chain_sums_ring(tm, counts, starts)
    same(r, t, "chain sums")
    chain_starts = np.nonzero(starts)[0]
    lens = np.diff(np.append(chain_starts, T))
    csum = np.concatenate([[0], np.cumsum(counts)])
    assert (t[chain_starts + lens - 1]
            == csum[chain_starts + lens] - csum[chain_starts]).all()


def test_chain_sums_ring_overflow():
    counts = np.full(4, 2**30, np.int64)
    starts = np.array([True, False, False, False])
    for mod, mesh in ((runipath, rmesh.make_mesh(3)),
                      (tunipath, tmesh.make_mesh(3, "cpu"))):
        with pytest.raises(OverflowError, match="int32 ring scan"):
            mod._chain_sums_ring(mesh, counts, starts)


def test_build_unipaths_on_a_mesh():
    """build_unipaths(mesh=) == the reference's with its mesh, and == the
    1-device result."""
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    codes = np.stack([g[s:s + 100] for s in range(0, 2900, 7)])
    from allpathslg_tpu.kmer import count as rcount
    ck = rcount.trim_to_host(rcount.count_reads_streaming(codes, 31))
    words = [np.asarray(w) for w in ck.words]
    counts = np.asarray(ck.counts)
    rm, tm = meshes(8)
    r = runipath.build_unipaths([jnp.asarray(w) for w in words], 31,
                                min_count=1, counts=jnp.asarray(counts),
                                mesh=rm)
    t = tunipath.build_unipaths(words, 31, min_count=1, counts=counts,
                                mesh=tm, device="cpu")
    t1 = tunipath.build_unipaths(words, 31, min_count=1, counts=counts,
                                 device="cpu")
    for ups in (t, t1):
        for k in ("bases", "offsets", "kmer_counts", "mean_cov"):
            assert np_(getattr(r, k)).tobytes() == \
                np_(getattr(ups, k)).tobytes(), k

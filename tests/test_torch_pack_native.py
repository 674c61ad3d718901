"""The port's native read packer (native/pack_reads.cpp behind
dtypes/packed.pack_codes, pack_quals and qual_palette_size) against the
reference's numpy packing, bit for bit: every length class, empty and
large batches, codes past 4, quals at 1, 16 and 17 values, and the views
callers pass (strided, gathered, Fortran-ordered, memory-mapped).
DeviceBatches.from_host against the reference's per-batch arrays through
convert.py; two threads packing at once; the upload span's bytes."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from allpathslg_tpu.dtypes import devcache as rdev  # noqa: E402
from allpathslg_tpu.dtypes import packed as rpk  # noqa: E402
from allpathslg_tpu_torch import convert, trace  # noqa: E402
from allpathslg_tpu_torch.dtypes import devcache as tdev  # noqa: E402
from allpathslg_tpu_torch.dtypes import packed as tpk  # noqa: E402

CPU = torch.device("cpu")
LENGTHS = [1, 15, 16, 17, 31, 32, 33, 37, 100, 101, 150, 203]
COUNTS = [0, 1, 7, 65_536]


def _codes(n, L, high, seed):
    return np.random.default_rng(seed).integers(0, high, (n, L)).astype(
        np.uint8)


def _quals(n, L, distinct, seed):
    """[n, L] uint8 quals holding `distinct` values (as many as fit)."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(256, distinct, replace=False).astype(np.uint8)
    flat = vals[rng.integers(0, distinct, n * L)]
    k = min(distinct, n * L)
    flat[:k] = vals[:k]
    return flat.reshape(n, L)


def _binned_quals(n, L, seed):
    """16 values, 0 among them, so the all-0 padding of a last batch
    keeps the palette."""
    binned = np.arange(0, 32, 2, dtype=np.uint8)
    return binned[np.random.default_rng(seed).integers(0, 16, (n, L))]


def _same_codes(codes):
    w, m, L = rpk.pack_codes(codes)
    tw, tm, tL = tpk.pack_codes(codes)
    assert tL == L
    for a, b in ((w, tw), (m, tm)):
        assert b.dtype == np.uint32 and b.shape == a.shape
        assert np.array_equal(a, b)


def _same_quals(quals):
    nib, pal, L = rpk.pack_quals(quals)
    tnib, tpal, tL = tpk.pack_quals(quals)
    assert tL == L
    assert tpk.qual_palette_size(quals) == np.count_nonzero(
        np.bincount(np.ravel(quals), minlength=256))
    if nib is None:
        assert tnib is None and np.array_equal(tpal, pal)
        return
    assert tnib.dtype == np.uint32 and tnib.shape == nib.shape
    assert tpal.dtype == np.uint8 and tpal.shape == (16,)
    assert np.array_equal(nib, tnib) and np.array_equal(pal, tpal)


@pytest.mark.parametrize("high", [5, 256], ids=["codes0-4", "bytes0-255"])
@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("L", LENGTHS)
def test_pack_codes_bit_identical(L, n, high):
    """Words and full-width N masks as the reference's, `code & 3` and
    `code == 4` for every byte."""
    _same_codes(_codes(n, L, high, seed=L * 7 + n + high))


@pytest.mark.parametrize("distinct", [1, 16, 17])
@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("L", LENGTHS)
def test_pack_quals_bit_identical(L, n, distinct):
    """Nibbles and the zero-padded palette as the reference's; 17 values
    give its raw fallback."""
    _same_quals(_quals(n, L, distinct, seed=L * 11 + n + distinct))


def _layouts(kind, tmp_path):
    base = _codes(300, 120, 5, seed=3)
    qbase = _quals(300, 120, 16, seed=4)
    if kind == "row_step":
        return base[::3], qbase[::3]
    if kind == "reversed_rows":
        return base[::-2], qbase[::-2]
    if kind == "column_slice":
        return base[:, 7:108], qbase[:, 7:108]
    if kind == "fancy_gather":
        rows = np.random.default_rng(5).integers(0, 300, 211)
        return base[rows], qbase[rows]
    if kind == "fortran":
        return np.asfortranarray(base), np.asfortranarray(qbase)
    assert kind == "mmap"
    np.save(tmp_path / "codes.npy", base)
    np.save(tmp_path / "quals.npy", qbase)
    codes = np.load(tmp_path / "codes.npy", mmap_mode="r")
    quals = np.load(tmp_path / "quals.npy", mmap_mode="r")
    assert not codes.flags.writeable
    return codes[40:250], quals[40:250]


@pytest.mark.parametrize("kind", ["row_step", "reversed_rows",
                                  "column_slice", "fancy_gather", "fortran",
                                  "mmap"])
def test_pack_views_callers_pass(kind, tmp_path):
    codes, quals = _layouts(kind, tmp_path)
    _same_codes(codes)
    _same_quals(quals)
    _same_quals(quals[:, ::2])          # neither contiguous nor row-walkable


def _reference_batches(codes, quals, batch, lengths=None):
    rdb = rdev.DeviceBatches.from_host(codes, quals, batch, lengths)
    return convert.device_batches(
        rdb.batch, rdb.L, rdb.n_real, rdb.words, rdb.nmask, rdb.qnib,
        rdb.qpal, () if lengths is None else rdb.lengths, device=CPU)


def _same_batches(a, b):
    assert (a.batch, a.L, a.n_real, a.n_batches) == (
        b.batch, b.L, b.n_real, b.n_batches)
    for part in ("words", "nmask", "qnib", "qpal", "lengths"):
        xs, ys = getattr(a, part), getattr(b, part)
        assert len(xs) == len(ys), part
        for x, y in zip(xs, ys):
            assert (x is None) == (y is None), part
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), part


def _whole_17_batch_16():
    """A read set with 17 quals in all and 16 in its first batch: the
    whole set's palette test sends every batch raw."""
    codes = _codes(700, 45, 5, seed=9)
    quals = _binned_quals(700, 45, seed=10)
    quals[600, 3] = 255
    assert len(np.unique(quals)) == 17 and len(np.unique(quals[:256])) == 16
    return codes, quals, None


@pytest.mark.parametrize("case", ["palette", "whole17_batch16", "no_quals"])
def test_from_host_matches_reference(case):
    if case == "palette":
        codes, quals = _codes(700, 101, 5, 11), _binned_quals(700, 101, 12)
        lengths = np.random.default_rng(13).integers(50, 102, 700)
    elif case == "whole17_batch16":
        codes, quals, lengths = _whole_17_batch_16()
    else:
        codes, quals = _codes(700, 37, 5, 14), None
        lengths = np.full(700, 37)
    got = tdev.DeviceBatches.from_host(codes, quals, 256, lengths,
                                       device=CPU)
    _same_batches(got, _reference_batches(codes, quals, 256, lengths))
    if case == "whole17_batch16":
        assert all(q is None for q in got.qnib)
        assert tpk.pack_quals(quals[:256])[0] is not None


def test_two_threads_pack_at_once():
    """Two threads pack different batches in turn with a short switch
    interval; every result is the reference's."""
    jobs = [(_codes(4096, 101, 5, s), _quals(4096, 101, 16, s + 1))
            for s in (21, 41)]
    want = [(rpk.pack_codes(c), rpk.pack_quals(q)) for c, q in jobs]
    bad = []

    def work(i):
        c, q = jobs[i]
        (w, m, _), (nib, pal, _) = want[i]
        for _ in range(40):
            tw, tm, _ = tpk.pack_codes(c)
            tnib, tpal, _ = tpk.pack_quals(q)
            if not (np.array_equal(w, tw) and np.array_equal(m, tm)
                    and np.array_equal(nib, tnib)
                    and np.array_equal(pal, tpal)):
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def _int64_bytes(arrays):
    return sum(np.asarray(a).astype(np.int64).nbytes for a in arrays
               if a is not None)


@pytest.fixture
def spans():
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        yield
    trace.clear()


def test_upload_span_counts_the_reference_bytes(spans):
    """The upload span's bytes are what the reference's arrays, widened
    to the device's int64 words, hold: the wire format did not move. Each
    native call opens upload.pack inside it, counting reads and bytes."""
    codes, quals = _codes(700, 101, 5, 31), _binned_quals(700, 101, 32)
    lengths = np.full(700, 101)
    tdev.DeviceBatches.from_host(codes, quals, 256, lengths, device=CPU)
    rdb = rdev.DeviceBatches.from_host(codes, quals, 256, lengths)
    want = (_int64_bytes(rdb.words) + _int64_bytes(rdb.nmask)
            + _int64_bytes(rdb.qnib)
            + sum(np.asarray(p).nbytes for p in rdb.qpal)
            + sum(np.asarray(x).nbytes for x in rdb.lengths))
    batch_q = _quals(300, 101, 16, 33)
    tpk.device_codes(codes[:300], CPU)
    tpk.device_quals(batch_q, CPU)
    w, m, _ = rpk.pack_codes(codes[:300])
    nib, pal, _ = rpk.pack_quals(batch_q)
    uploads = [s for s in trace.spans() if s.name == "upload"]
    assert [s.counters["bytes"] for s in uploads] == [
        want, w.nbytes + m.nbytes, pal.nbytes + nib.nbytes]
    packs = [s for s in trace.spans() if s.name == "upload.pack"]
    assert all(s.parent is not None and s.parent.name == "upload"
               for s in packs)
    # from_host: codes and quals of 3 batches of 256; then one call each
    assert [s.counters["reads"] for s in packs] == [256] * 6 + [300, 300]
    assert [s.counters["bytes_in"] for s in packs] == (
        [256 * 101] * 6 + [300 * 101] * 2)

"""Port bucketed count engine (ops/bucket_count.py, kmer/count.
spectrum_reads_auto, ops/sort.sort_rows_by_words, ops/cuda/row_sort_cuda)
vs the reference (allpathslg_tpu/ops/bucket_count.py).

The same seeded numpy words go to both packages; every output is an
integer array and must be exactly equal: the grouped words and max_run,
count_grouped's (words, counts, starts) on its first attempt, its retry
with doubled slack and its flat fallback, spectrum_grouped's (spec,
n_unique, ok) with and without slab overflow, grouping_plan, and
spectrum_reads_auto under both engines. On the CPU the row sort is its
plain version; it is held against a per-row np.lexsort here, and the
`cuda`-marked cases hold the kernel against it on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.kmer import count as rcount, kmerize as rkmerize  # noqa: E402
from allpathslg_tpu.ops import bucket_count as rbucket  # noqa: E402
from allpathslg_tpu_torch.kmer import count as tcount  # noqa: E402
from allpathslg_tpu_torch.ops import bucket_count as tbucket  # noqa: E402
from allpathslg_tpu_torch.ops import sort as tsort  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import row_sort_cuda  # noqa: E402

torch.set_num_threads(2)
SENT = 0xFFFFFFFF


def _kmer_words(n_reads, read_len, K, seed, n_frac=0.0):
    """Flat canonical K-mer words (numpy uint32, sentinels at invalid
    windows) of random reads, through the reference's kmerize."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, read_len)).astype(np.uint8)
    codes[rng.random(codes.shape) < n_frac] = 4
    canon, valid = rkmerize.kmer_windows(jnp.asarray(codes), K)
    flat, _ = rkmerize.flatten_kmers(canon, valid, K)
    return [np.asarray(w) for w in flat]


def _heavy_words(n, seed=1):
    """7 x 3 distinct keys (as tests/test_bucket_count.py): long runs; at
    2**17 keys in tiles of 1024 some slab overflows the first slack."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 7, n).astype(np.uint32),
            rng.integers(0, 3, n).astype(np.uint32)]


# (name, words, tile_rows, n_buckets): count_grouped returns on its first
# attempt, after the retry with doubled slack, or through the flat sort
CASES = {
    "k24_first": (lambda: _kmer_words(400, 60, 24, 0, 0.01), 2048, 16),
    "heavy_retry": (lambda: _heavy_words(1 << 17), 1024, 8),
    "one_key_fallback": (lambda: [np.zeros(4096, np.uint32)] * 2, 1024, 8),
    "k96_six_words": (lambda: _kmer_words(80, 120, 96, 2), 1024, 8),
}


def _t(words):
    return [torch.from_numpy(np.asarray(w).astype(np.int64)) for w in words]


def _j(words):
    return [jnp.asarray(np.asarray(w, dtype=np.uint32)) for w in words]


def _eq(ref, port):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  port.numpy().astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_keys_matches_reference(case):
    make, tile_rows, n_buckets = CASES[case]
    words = make()
    N, R, B, S = rbucket.grouping_plan(words[0].shape[0], tile_rows,
                                       n_buckets)
    rg, rmax = rbucket.group_keys(rbucket._pad_to(_j(words), N), R, B, S)
    tg, tmax = tbucket.group_keys(tbucket._pad_to(_t(words), N), R, B, S)
    assert len(tg) == len(rg)
    for a, b in zip(rg, tg):
        _eq(a, b)
    assert tmax.dtype == torch.int32 and int(tmax) == int(rmax)


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_grouped_matches_reference(case):
    make, tile_rows, n_buckets = CASES[case]
    words = make()
    rg, rc, rs = rbucket.count_grouped(_j(words), tile_rows, n_buckets)
    tg, tc, ts = tbucket.count_grouped(_t(words), tile_rows, n_buckets)
    for a, b in zip(rg, tg):
        _eq(a, b)
    _eq(rc, tc)
    _eq(rs, ts)
    assert tc.dtype == torch.int32 and ts.dtype == torch.bool
    # the path that returned, from the output's length
    N, R, B, _ = rbucket.grouping_plan(words[0].shape[0], tile_rows,
                                       n_buckets)
    T = N // R
    slots = [int(np.ceil(N / (B * T) * s)) for s in (1.5, 3.0)]
    want = {"k24_first": B * T * slots[0], "k96_six_words": B * T * slots[0],
            "heavy_retry": B * T * slots[1], "one_key_fallback": N}[case]
    assert tg[0].shape[0] == want


@pytest.mark.parametrize("slots_scale", [1.0, 0.25], ids=["ok", "overflow"])
def test_spectrum_grouped_matches_reference(slots_scale):
    words = _kmer_words(512, 80, 24, 3, n_frac=0.01)
    N, R, B, S = rbucket.grouping_plan(words[0].shape[0], tile_rows=2048,
                                       n_buckets=16)
    S = max(1, int(S * slots_scale))
    rspec, rnu, rok = rbucket.spectrum_grouped(
        rbucket._pad_to(_j(words), N), R, B, S, 63)
    tspec, tnu, tok = tbucket.spectrum_grouped(
        tbucket._pad_to(_t(words), N), R, B, S, 63)
    _eq(rspec, tspec)
    assert int(tnu) == int(rnu) and bool(tok) == bool(rok)
    assert bool(tok) == (slots_scale == 1.0)


@pytest.mark.parametrize("n_rows", [1, 5, 1000, 1023, 1024, 1025, 4097,
                                    65_539, 131_071, 131_072, 131_073,
                                    16_646_144, 1 << 20])
def test_grouping_plan_matches_reference(n_rows):
    assert tbucket.grouping_plan(n_rows) == rbucket.grouping_plan(n_rows)
    assert (tbucket.grouping_plan(n_rows, 2048, 16, 3.0)
            == rbucket.grouping_plan(n_rows, 2048, 16, 3.0))


def test_pad_to_matches_reference():
    words = _kmer_words(10, 40, 24, 5)
    n = words[0].shape[0]
    for a, b in zip(rbucket._pad_to(_j(words), n + 77),
                    tbucket._pad_to(_t(words), n + 77)):
        _eq(a, b)
    assert tbucket._pad_to(_t(words), n)[0].shape[0] == n


def _lexsort_rows(words):
    """Per-row stable lexicographic order (np.lexsort): (sorted words,
    permutation)."""
    perm = np.stack([np.lexsort([w[r] for w in reversed(words)])
                     for r in range(words[0].shape[0])])
    return [np.take_along_axis(w, perm, 1) for w in words], perm


@pytest.mark.parametrize("rows,row_len", [(1, 1), (1, 999), (3, 4097),
                                          (7, 1000)])
@pytest.mark.parametrize("n_words", [1, 2, 3, 6])
def test_sort_rows_by_words_matches_lexsort(rows, row_len, n_words):
    rng = np.random.default_rng(rows * 100 + row_len + n_words)
    words = [rng.integers(0, 5, (rows, row_len)).astype(np.int64)
             for _ in range(n_words)]
    words[-1] = rng.integers(0, 2**32, (rows, row_len)).astype(np.int64)
    sent = rng.random((rows, row_len)) < 0.05
    for w in words:
        w[sent] = SENT
    if rows > 2:
        for w in words:
            w[1] = SENT                         # a row of sentinels only
    want, wperm = _lexsort_rows(words)
    got, gperm = tsort.sort_rows_by_words([torch.from_numpy(w)
                                           for w in words])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b.numpy())
    assert gperm.dtype == torch.int32
    np.testing.assert_array_equal(wperm, gperm.numpy())


@pytest.mark.parametrize("key_bits", [32, 64])
def test_row_sort_plain_orders_unsigned_keys(key_bits):
    rng = np.random.default_rng(key_bits)
    hi = 2**32 if key_bits == 32 else 2**64
    u = rng.integers(0, hi, (5, 3001), dtype=np.uint64)
    u[:, ::7] = u[0, 0]                               # ties: stability
    u[rng.random(u.shape) < 0.02] = hi - 1            # the all-ones key
    keys = torch.from_numpy(u.view(np.int64))
    got, perm = row_sort_cuda.row_sort(keys, key_bits)
    want = np.stack([np.argsort(row, kind="stable") for row in u])
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.take_along_axis(u, want, 1))
    assert (got.numpy().view(np.uint64)[:, -1] == hi - 1).all()


@pytest.mark.parametrize("engine,reads", [
    ("flat", "random"), ("bucketed", "random"), ("bucketed", "one_key")])
def test_spectrum_reads_auto_matches_reference(monkeypatch, tmp_path,
                                               engine, reads):
    """Both packages read APLG_COUNT_ENGINE; under "bucketed" reads of one
    repeated base overflow every slab and take the flat path."""
    monkeypatch.setenv("APLG_COUNT_ENGINE", engine)
    monkeypatch.setenv("APLG_TUNING_FILE", str(tmp_path / "tuning.json"))
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (256, 60)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    if reads == "one_key":
        codes[:] = 0
    rspec, rnu = rcount.spectrum_reads_auto(jnp.asarray(codes), 24, 63)
    tspec, tnu = tcount.spectrum_reads_auto(torch.from_numpy(codes), 24, 63)
    _eq(rspec, tspec)
    assert int(tnu) == int(rnu)
    fspec, fnu = tcount.spectrum_reads(torch.from_numpy(codes), 24, 63)
    assert torch.equal(tspec, fspec) and int(tnu) == int(fnu)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,row_len", [(1, 1), (3, 12_345),
                                          (127, 131_072)])
@pytest.mark.parametrize("key_bits", [32, 64])
def test_row_sort_kernel_matches_plain_version(cuda_device, rows, row_len,
                                               key_bits):
    rng = np.random.default_rng(rows + key_bits)
    hi = 2**32 if key_bits == 32 else 2**64
    u = rng.integers(0, hi, (rows, row_len), dtype=np.uint64)
    u[rng.random(u.shape) < 0.01] = hi - 1
    keys = torch.from_numpy(u.view(np.int64)).to(cuda_device)
    got, gperm = row_sort_cuda.row_sort(keys, key_bits)
    want, wperm = row_sort_cuda.row_sort_plain(keys, key_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(gperm, wperm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_count_grouped_card_matches_cpu(cuda_device, case):
    make, tile_rows, n_buckets = CASES[case]
    words = _t(make())
    got = tbucket.count_grouped([w.to(cuda_device) for w in words],
                                tile_rows, n_buckets)
    want = tbucket.count_grouped(words, tile_rows, n_buckets)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])

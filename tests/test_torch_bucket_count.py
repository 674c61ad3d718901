"""Port bucketed count engine (ops/bucket_count.py, kmer/count.
spectrum_reads_auto, ops/sort.sort_rows_by_words, ops/cuda/row_sort_cuda)
vs the reference (allpathslg_tpu/ops/bucket_count.py).

The same seeded numpy words go to both packages; every output is an
integer array and must be exactly equal: the grouped words and max_run,
count_grouped's (words, counts, starts) on its first attempt, its retry
with doubled slack and its flat fallback, spectrum_grouped's (spec,
n_unique, ok) with and without slab overflow, grouping_plan, and
spectrum_reads_auto under both engines. On the CPU the row sort is its
plain version; it is held against a per-row np.lexsort and argsort here,
with and without an initial index, on the shapes a row-scoped one-sweep
sort can get wrong, beside its scratch layout and its per-row histograms;
the `cuda`-marked cases hold the kernel against it on a card.
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


def _row_case(case):
    """(uint64 keys [rows, row_len], key_bits) of a shape or key set that a
    row-scoped one-sweep sort can get wrong."""
    rng = np.random.default_rng(sum(map(ord, case)))
    top = np.uint64(2**64 - 1)

    def rand(rows, row_len):
        return rng.integers(0, 2**64 - 1, (rows, row_len), dtype=np.uint64,
                            endpoint=True)

    if case == "short_rows":                    # 4,096 rows of one tile
        u = rand(4096, 600)
    elif case == "rows_end_mid_tile":           # 1.5 tiles a row
        u = rand(3, 6145)
    elif case == "one_bucket_rows":             # rows 1, 2 agree everywhere
        u = rand(5, 9000)
        u[1] = u[0, 0]
        u[2] = u[0, 1]
        u[2, ::97] = top
    elif case == "k24_low_zero":                # K=24 keys, low 16 bits 0
        u = rand(6, 20_000) >> np.uint64(16) << np.uint64(16)
    elif case == "sentinel_rows":               # rows 0 and 3 sentinels only
        u = rand(5, 7000)
        u[[0, 3]] = top
    elif case == "one_word_short_rows":
        u = rng.integers(0, 2**32, (300, 2500), dtype=np.uint64)
        u[rng.random(u.shape) < 0.05] = 2**32 - 1
        return u, 32
    elif case == "slabs":                       # the flagship's K=24 slabs
        u = rand(127, 196_723)
    else:
        raise ValueError(case)
    u[rng.random(u.shape) < 0.01] = top
    return u, 64


ROW_CASES = ("short_rows", "rows_end_mid_tile", "one_bucket_rows",
             "k24_low_zero", "sentinel_rows", "one_word_short_rows")


def _row_perms(shape, seed):
    """A random permutation of each row (int32): an initial index."""
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random(shape), axis=1).astype(np.int32)


@pytest.mark.parametrize("case", ROW_CASES)
@pytest.mark.parametrize("with_idx", [False, True])
def test_row_sort_cases_match_numpy(case, with_idx):
    """The plain version on the kernel's hard cases, with and without an
    initial index, against a stable numpy argsort of each row."""
    u, key_bits = _row_case(case)
    want = np.argsort(u, axis=1, kind="stable")
    idx = _row_perms(u.shape, 3) if with_idx else None
    got, perm = row_sort_cuda.row_sort(
        torch.from_numpy(u.view(np.int64)), key_bits,
        None if idx is None else torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.take_along_axis(u, want, 1))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(
        perm.numpy(), want if idx is None else np.take_along_axis(idx, want,
                                                                  1))


@pytest.mark.parametrize("key_bits", [32, 64])
def test_row_sort_initial_index_composes_passes(key_bits):
    """Sorting by a low key, then by a high key with the first
    permutation as the initial index, orders rows by (high, low) stably:
    what sort_rows_by_words does with word groups."""
    rng = np.random.default_rng(key_bits + 1)
    low = rng.integers(0, 50, (4, 3000)).astype(np.int64)
    high = rng.integers(0, 20, (4, 3000)).astype(np.int64)
    _, p = row_sort_cuda.row_sort(torch.from_numpy(low), key_bits)
    high_by_p = np.take_along_axis(high, p.numpy().astype(np.int64), 1)
    _, perm = row_sort_cuda.row_sort(torch.from_numpy(high_by_p), key_bits,
                                     p)
    want = np.stack([np.lexsort([low[r], high[r]]) for r in range(4)])
    np.testing.assert_array_equal(perm.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_row_sort_refuses_a_bad_initial_index(bad):
    keys = torch.zeros((2, 10), dtype=torch.int64)
    idx = (torch.zeros((2, 10), dtype=torch.int64) if bad == "dtype"
           else torch.zeros((2, 9), dtype=torch.int32))
    with pytest.raises(ValueError, match="idx"):
        row_sort_cuda.row_sort(keys, 64, idx)


@pytest.mark.parametrize("rows,row_len,key_bits,tile", [
    (127, 131_072, 64, 4096), (127, 196_723, 64, 4096),
    (55, 131_072, 32, 6144), (1, 1, 64, 4096), (4096, 600, 32, 4096)])
def test_scratch_layout(rows, row_len, key_bits, tile):
    """The regions follow each other without overlap: the union, one
    histogram a row, a status region of rows x tiles x 257 words and a
    tile counter for each digit position, then the bases (the words
    before them are zeroed)."""
    lay = row_sort_cuda.scratch_layout(rows, row_len, key_bits, tile)
    positions = key_bits // 8
    tiles = -(-row_len // tile)
    assert lay.row_hist == 8 * 256 + 1 == row_sort_cuda.HIST_WORDS
    assert lay.status - lay.row_hist == rows * (positions * 256 + 1)
    assert lay.status_stride == rows * tiles * 257 + 1
    assert lay.bases - lay.status == positions * lay.status_stride
    assert lay.total - lay.bases == rows * positions * 257


@pytest.mark.parametrize("key_bits", [32, 64])
@pytest.mark.parametrize("case", ["k24_low_zero", "sentinel_rows",
                                  "one_bucket_rows"])
def test_row_histogram_plain_matches_numpy(case, key_bits):
    """Each row's digit counts over its keys that are not all-ones, its
    all-ones count and its bucket starts, by numpy bincount; the union
    equals the flat sort's histogram of all the keys, so the plan is the
    flat plan."""
    from allpathslg_tpu_torch.ops.cuda import sort_cuda

    u, _ = _row_case(case)
    if key_bits == 32:
        u = u >> np.uint64(32)
    ones = np.uint64(2**key_bits - 1)
    keys = torch.from_numpy(u.view(np.int64))
    got = row_sort_cuda.row_histogram(keys, key_bits)
    positions = key_bits // 8
    for r in range(u.shape[0]):
        rest = u[r][u[r] != ones]
        want = np.stack([np.bincount(
            ((rest >> np.uint64(8 * p)) & np.uint64(255)).astype(np.int64),
            minlength=256) for p in range(positions)])
        np.testing.assert_array_equal(got.counts[r].numpy(), want)
        assert int(got.ones[r]) == int((u[r] == ones).sum())
        bases = np.concatenate([np.zeros((positions, 1), np.int64),
                                np.cumsum(want, 1)], 1)
        np.testing.assert_array_equal(got.bases[r].numpy(), bases)
    flat, n_ones = sort_cuda.digit_histogram_plain(keys.reshape(-1),
                                                   key_bits)
    np.testing.assert_array_equal(got.union, flat)
    assert got.n_ones == n_ones
    n = u.size
    assert (sort_cuda.plan_passes(got.union, got.n_ones, n, key_bits)
            == sort_cuda.plan_passes(flat, n_ones, n, key_bits))


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
@pytest.mark.parametrize("case", ROW_CASES + ("slabs",))
@pytest.mark.parametrize("with_idx", [False, True])
def test_row_sort_kernel_matches_plain_on_hard_cases(cuda_device, case,
                                                     with_idx):
    u, key_bits = _row_case(case)
    keys = torch.from_numpy(u.view(np.int64)).to(cuda_device)
    idx = (torch.from_numpy(_row_perms(u.shape, 5)).to(cuda_device)
           if with_idx else None)
    got, gperm = row_sort_cuda.row_sort(keys, key_bits, idx)
    want, wperm = row_sort_cuda.row_sort_plain(keys, key_bits, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(gperm, wperm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short_rows", "k24_low_zero", "slabs"])
def test_row_histogram_kernel_matches_plain(cuda_device, case):
    u, key_bits = _row_case(case)
    keys = torch.from_numpy(u.view(np.int64)).to(cuda_device)
    got = row_sort_cuda.row_histogram(keys, key_bits)
    want = row_sort_cuda.row_histogram_plain(keys, key_bits)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got.union, want.union)
    assert got.n_ones == want.n_ones


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

"""Port sort (ops/sort.py + ops/cuda/sort_cuda.py) vs the reference.

On the CPU the port's sort takes the plain PyTorch version of the Hopper
radix sort; it must equal the reference's stable `lax.sort`
(ops/sort.sort_by_words), its key-only counting sort (kmer/count.
count_sorted), the Pallas bitonic kernel it replaces (sort_two_words,
interpret mode, as tests/test_sort_pallas.py runs it) and np.lexsort —
exactly, since every value is an integer. The pass plan of the kernel
(plan_passes) is held here through a plain emulation of its passes on
chip_smoke.py's adversarial keys. The `cuda`-marked cases hold the kernel
against the plain version on a card and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.kmer import count as rcount  # noqa: E402
from allpathslg_tpu.ops import segmented as rseg  # noqa: E402
from allpathslg_tpu.ops import sort as rsort  # noqa: E402
from allpathslg_tpu.ops.pallas import sort_pallas  # noqa: E402
from allpathslg_tpu_torch.kmer import count as tcount  # noqa: E402
from allpathslg_tpu_torch.ops import segmented as tseg  # noqa: E402
from allpathslg_tpu_torch.ops import sort as tsort  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import sort_cuda  # noqa: E402
from chip_smoke import SORT_CASES, adversarial_sort_keys  # noqa: E402

torch.set_num_threads(2)
SENT = 0xFFFFFFFF


def _keys(n, W, seed, hi=1 << 32, sentinel_frac=0.1):
    """W uint32 word arrays with many duplicates and sentinel rows."""
    rng = np.random.default_rng(seed)
    ws = [rng.integers(0, 7, n).astype(np.uint32)]          # duplicate-heavy
    ws += [rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)
           for _ in range(W - 1)]
    sent = rng.random(n) < sentinel_frac
    for w in ws:
        w[sent] = SENT
    return ws


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 777, 5000])
def test_sort_by_words_matches_reference_and_lexsort(W, n):
    ws = _keys(n, W, seed=10 * W + n)
    rng = np.random.default_rng(n)
    pay = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    slot = np.arange(n, dtype=np.int32)
    rk, (rp, rs) = rsort.sort_by_words([jnp.asarray(w) for w in ws],
                                       [jnp.asarray(pay), jnp.asarray(slot)])
    tk, (tp, ts) = tsort.sort_by_words([_t(w) for w in ws],
                                       [torch.from_numpy(pay),
                                        torch.from_numpy(slot)])
    order = np.lexsort(ws[::-1])                      # stable, w0 major
    for r, t, w in zip(rk, tk, ws):
        assert np.array_equal(np.asarray(r).astype(np.int64), _np(t))
        assert np.array_equal(_np(t), w[order].astype(np.int64))
    assert np.array_equal(np.asarray(rp), _np(tp))
    assert np.array_equal(_np(ts), order.astype(np.int32))
    assert np.array_equal(np.asarray(rs), _np(ts))


@pytest.mark.parametrize("W", [1, 2, 3])
def test_count_sorted_matches_reference(W):
    ws = _keys(4000, W, seed=W, hi=4)
    rk, rc, rst = rcount.count_sorted([jnp.asarray(w) for w in ws])
    tk, tc, tst = tcount.count_sorted([_t(w) for w in ws])
    for r, t in zip(rk, tk):
        assert np.array_equal(np.asarray(r).astype(np.int64), _np(t))
    assert np.array_equal(np.asarray(rc), _np(tc))
    assert np.array_equal(np.asarray(rst), _np(tst))


@pytest.mark.parametrize("n,seed", [(1000, 0), (777, 7)])
def test_two_word_sort_matches_pallas_kernel(n, seed):
    """The kernel this sort replaces: sort_two_words (unstable, keys only)."""
    rng = np.random.default_rng(seed)
    w0 = rng.integers(0, 50, n).astype(np.uint32)
    w1 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s0, s1 = sort_pallas.sort_two_words(jnp.asarray(w0), jnp.asarray(w1),
                                        tile_r_bits=4, interpret=True)
    (t0, t1), _ = tsort.sort_by_words([_t(w0), _t(w1)])
    assert np.array_equal(np.asarray(s0).astype(np.int64), _np(t0))
    assert np.array_equal(np.asarray(s1).astype(np.int64), _np(t1))


def test_plain_sort_orders_unsigned_and_is_stable():
    """radix_sort_plain: unsigned 64-bit order (keys with w0 >= 2**31 are
    negative as int64), equal keys in input order."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2**64, 20000, dtype=np.uint64)
    u[::3] = u[1::3][: len(u[::3])]                       # duplicates
    u[::7] = np.uint64(2**64 - 1)                         # sentinels
    keys = torch.from_numpy(u.view(np.int64))
    skeys, perm = sort_cuda.radix_sort(keys, 64)
    order = np.argsort(u, kind="stable")
    assert perm.dtype == torch.int32
    assert np.array_equal(_np(perm), order)
    assert np.array_equal(_np(skeys).view(np.uint64), u[order])


def test_run_helpers_match_reference():
    rng = np.random.default_rng(5)
    w = np.sort(rng.integers(0, 30, 3000).astype(np.uint32))
    rst = rsort.run_starts([jnp.asarray(w)])
    tst = tsort.run_starts([_t(w)])
    assert np.array_equal(np.asarray(rst), _np(tst))
    assert np.array_equal(np.asarray(rseg.run_lengths(rst)),
                          _np(tseg.run_lengths(tst)))
    assert np.array_equal(np.asarray(rseg.position_in_run(rst)),
                          _np(tseg.position_in_run(tst)))
    # a run-start mask with no start at 0 (the contract's edge)
    st = np.zeros(50, bool)
    st[[7, 20, 21]] = True
    assert np.array_equal(
        np.asarray(rseg.position_in_run(jnp.asarray(st))),
        _np(tseg.position_in_run(torch.from_numpy(st))))


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel (or raises), never to torch.sort."""
    calls = []
    monkeypatch.setattr(sort_cuda, "_radix_sort_cuda",
                        lambda k, b: calls.append(b) or (k, k))
    monkeypatch.setattr(sort_cuda, "radix_sort_plain",
                        lambda k, b: pytest.fail("plain version on CUDA"))

    class FakeCuda:
        device = torch.device("cuda", 0)

    sort_cuda.radix_sort(FakeCuda(), 64)
    assert calls == [64]
    with pytest.raises(ValueError):
        sort_cuda.radix_sort(torch.zeros(3, dtype=torch.int64,
                                         device="meta"), 64)


def _lsd_by_plan(keys, key_bits: int, ones_in: str):
    """The kernel's algorithm in plain torch: plan_passes over the plain
    histogram, one stable sort per planned 8-bit digit, and all-ones keys
    in a 257th bucket in the last pass only ("last") or in every pass
    ("every", the kernel's rule)."""
    hist, n_ones = sort_cuda.digit_histogram_plain(keys, key_bits)
    shifts = sort_cuda.plan_passes(hist, n_ones, keys.numel(), key_bits)
    ones = sort_cuda.all_ones(key_bits)
    cur, perm = keys, torch.arange(keys.numel())
    for j, s in enumerate(shifts):
        bucket = (cur >> s) & 0xFF
        if ones_in == "every" or j == len(shifts) - 1:
            bucket = torch.where(cur == ones, 256, bucket)
        _, p = torch.sort(bucket, stable=True)
        cur, perm = cur[p], perm[p]
    return cur, perm.to(torch.int32), shifts


@pytest.mark.parametrize("ones_in", ["last", "every"])
@pytest.mark.parametrize("case,n", [(c, 3000) for c in SORT_CASES]
                         + [(c, 1) for c in SORT_CASES] + [("random64", 0)])
def test_planned_passes_sort_like_the_plain_version(case, n, ones_in):
    u, key_bits, want_passes = adversarial_sort_keys(case, n,
                                                     seed=len(case) + n)
    keys = torch.from_numpy(u.view(np.int64))
    got, gperm, shifts = _lsd_by_plan(keys, key_bits, ones_in)
    want, wperm = sort_cuda.radix_sort_plain(keys, key_bits)
    assert torch.equal(got, want) and torch.equal(gperm, wperm)
    assert np.array_equal(gperm.numpy(), np.argsort(u, kind="stable"))
    assert len(shifts) == (want_passes if n > 1 else 0)
    # the plain histogram against numpy's
    ones = np.uint64(2**key_bits - 1)
    rest = u[u != ones]
    hist, n_ones = sort_cuda.digit_histogram_plain(keys, key_bits)
    assert n_ones == int((u == ones).sum())
    assert np.array_equal(hist, np.stack([
        np.bincount(((rest >> np.uint64(s)) & np.uint64(0xFF))
                    .astype(np.int64), minlength=256)
        for s in range(0, key_bits, 8)]))


@pytest.mark.parametrize("hist_rows,n_ones,n,key_bits,want", [
    ([[5] + [0] * 255] * 8, 0, 5, 64, []),            # all keys equal
    ([[0] * 256] * 8, 4, 4, 64, []),                  # all keys all-ones
    ([[5] + [0] * 255] * 8, 2, 7, 64, [0]),           # partition only
    ([[3, 2] + [0] * 254] * 4, 0, 5, 32, [0, 8, 16, 24]),
    ([[5] + [0] * 255] * 7 + [[4, 1] + [0] * 254], 9, 14, 64, [56]),
])
def test_plan_passes_rules(hist_rows, n_ones, n, key_bits, want):
    assert sort_cuda.plan_passes(np.array(hist_rows), n_ones, n,
                                 key_bits) == want


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 1 << 20])
@pytest.mark.parametrize("key_bits", [32, 64])
def test_kernel_matches_plain_version(cuda_device, n, key_bits):
    rng = np.random.default_rng(n + key_bits)
    hi = 2**32 if key_bits == 32 else 2**64
    u = rng.integers(0, hi, n, dtype=np.uint64)
    u[rng.random(n) < 0.3] = u[0]
    keys = torch.from_numpy(u.view(np.int64)).to(cuda_device)
    got, gperm = sort_cuda.radix_sort(keys, key_bits)
    want, wperm = sort_cuda.radix_sort_plain(keys, key_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(gperm, wperm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SORT_CASES)
def test_kernel_on_adversarial_keys(cuda_device, case):
    u, key_bits, want_passes = adversarial_sort_keys(case, 1 << 20,
                                                     seed=len(case))
    keys = torch.from_numpy(u.view(np.int64)).to(cuda_device)
    hist, n_ones = sort_cuda.digit_histogram(keys, key_bits)
    want_hist, want_ones = sort_cuda.digit_histogram_plain(keys, key_bits)
    assert np.array_equal(hist, want_hist) and n_ones == want_ones
    assert len(sort_cuda.plan_passes(hist, n_ones, keys.numel(),
                                     key_bits)) == want_passes
    got, gperm = sort_cuda.radix_sort(keys, key_bits)
    want, wperm = sort_cuda.radix_sort_plain(keys, key_bits)
    assert torch.equal(got, want) and torch.equal(gperm, wperm)

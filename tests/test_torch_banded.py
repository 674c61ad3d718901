"""Port banded DP (ops/banded.py + ops/cuda/banded_cuda.py) vs the reference.

On the CPU the port's `banded_align` must equal the reference's jnp
`banded_align`, the Pallas bit-parallel kernel it stands beside
(`banded_align_bp`, interpret mode, as tests/test_banded_bp.py runs it)
and `np_banded_oracle`, exactly: every value is an integer. The wrapper of
the Hopper kernel takes its plain version on a CPU tensor, which must
equal `banded_align_bp` also on queries holding code 4.

The two reference implementations disagree where a query base is N (code
4) opposite a target code 4 (the rescue's pad past a contig end): the jnp
`banded_align` counts it as a match, the Pallas kernel does not. A test
shows this in the reference itself; the port mirrors each side. The
`cuda`-marked case holds the kernel against the plain version on a card
and skips without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.ops import banded as rbanded  # noqa: E402
from allpathslg_tpu.ops.pallas import banded_bp as rbp  # noqa: E402
from allpathslg_tpu_torch import trace  # noqa: E402
from allpathslg_tpu_torch.ops import banded as tbanded  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import banded_cuda  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import banded_general_cuda  # noqa: E402

torch.set_num_threads(2)
BIG = 1 << 20


def _batch(rng, B, Lq, Lt, band, n_frac=0.0):
    """Mutated-copy targets for half the batch, ragged q_len/t_len, and
    offsets reaching past the feasible range on both sides."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    for i in range(0, B, 2):
        n = min(Lq, Lt)
        t[i, :n] = q[i, :n]
        p = rng.integers(0, Lt, int(rng.integers(0, 5)))
        t[i, p] = rng.integers(0, 4, len(p))
    if n_frac:
        q[rng.random((B, Lq)) < n_frac] = 4
        t[:, Lt - 4:] = 4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    ql[0] = 0
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    off = rng.integers(-(Lq + band) - 3, Lt + band + 4, B).astype(np.int32)
    off[1::2] = rng.integers(-band, band + 1, len(off[1::2]))
    return q, ql, t, tl, off


def _ref(fn, arrays, band, **kw):
    c, e = fn(*(jnp.asarray(a) for a in arrays), band=band, **kw)
    return np.asarray(c), np.asarray(e)


def _port(fn, arrays, band):
    c, e = fn(*(torch.from_numpy(a) for a in arrays), band=band)
    assert c.dtype == e.dtype == torch.int32
    return c.numpy(), e.numpy()


@pytest.mark.parametrize("band", [1, 4, 8, 15])
def test_banded_align_matches_reference_bp_and_oracle(band):
    rng = np.random.default_rng(100 + band)
    arrays = _batch(rng, 96, 70, 90, band)
    got = _port(tbanded.banded_align, arrays, band)
    want = _ref(rbanded.banded_align, arrays, band)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    bp = _ref(rbp.banded_align_bp, arrays, band, interpret=True)
    np.testing.assert_array_equal(got[0], bp[0])
    np.testing.assert_array_equal(got[1], bp[1])
    assert (got[0] < BIG).sum() > 20          # many problems have a path
    assert (got[0] >= BIG).sum() > 5          # and infeasible offsets die
    q, ql, t, tl, off = arrays
    for i in range(0, 96, 5):
        wc, we = rbanded.np_banded_oracle(q[i, :ql[i]], t[i, :tl[i]],
                                          int(off[i]), band)
        pc, pe = tbanded.np_banded_oracle(q[i, :ql[i]], t[i, :tl[i]],
                                          int(off[i]), band)
        assert (pc, pe) == (wc, we)
        assert got[0][i] == wc
        if wc < BIG:
            assert got[1][i] == we


def test_rescue_shape_matches_reference():
    """The align_frags rescue's shape, 260 x 276 at band 8, on a few rows."""
    rng = np.random.default_rng(7)
    arrays = _batch(rng, 24, 260, 276, 8)
    got = _port(tbanded.banded_align, arrays, 8)
    want = _ref(rbanded.banded_align, arrays, 8)
    bp = _ref(rbp.banded_align_bp, arrays, 8, interpret=True)
    for w in (want, bp):
        np.testing.assert_array_equal(got[0], w[0])
        np.testing.assert_array_equal(got[1], w[1])


@pytest.mark.parametrize("band", [1, 8, 15])
def test_bp_wrapper_on_cpu_matches_pallas_kernel_with_n(band):
    """The kernel's plain version (the wrapper on a CPU tensor) equals the
    Pallas kernel also where queries and targets hold code 4."""
    rng = np.random.default_rng(200 + band)
    arrays = _batch(rng, 64, 50, 70, band, n_frac=0.05)
    got = _port(banded_cuda.banded_align_bp, arrays, band)
    bp = _ref(rbp.banded_align_bp, arrays, band, interpret=True)
    np.testing.assert_array_equal(got[0], bp[0])
    np.testing.assert_array_equal(got[1], bp[1])


def _n_opposite_pad():
    """One crafted problem: the query ends in an N, the target's last
    column is the pad code 4, offset 0, band 2."""
    q = np.array([[0, 1, 2, 3, 4]], np.uint8)
    t = np.array([[0, 1, 2, 3, 4]], np.uint8)
    ql = np.array([5], np.int32)
    tl = np.array([5], np.int32)
    off = np.array([0], np.int32)
    return q, ql, t, tl, off


def test_reference_disagrees_on_query_n_against_pad():
    """In the JAX package itself, jnp banded_align lets the query N match
    the pad (cost 0), the Pallas bit-parallel kernel does not (cost 1).
    The port mirrors each: banded_align the first, the kernel's wrapper
    the second."""
    arrays = _n_opposite_pad()
    jnp_c, jnp_e = _ref(rbanded.banded_align, arrays, 2)
    bp_c, bp_e = _ref(rbp.banded_align_bp, arrays, 2, interpret=True)
    assert (int(jnp_c[0]), int(jnp_e[0])) == (0, 5)
    assert int(bp_c[0]) == 1
    assert rbanded.np_banded_oracle(arrays[0][0], arrays[2][0], 0, 2)[0] == 0
    got = _port(tbanded.banded_align, arrays, 2)
    assert (int(got[0][0]), int(got[1][0])) == (int(jnp_c[0]), int(jnp_e[0]))
    got_bp = _port(banded_cuda.banded_align_bp, arrays, 2)
    assert (int(got_bp[0][0]), int(got_bp[1][0])) == \
        (int(bp_c[0]), int(bp_e[0]))
    # the kernel's semantics are the plain version's once query code 4
    # becomes a code that matches nothing
    q6 = np.where(arrays[0] == 4, 6, arrays[0]).astype(np.uint8)
    got6 = _port(tbanded.banded_align, (q6,) + arrays[1:], 2)
    assert (int(got6[0][0]), int(got6[1][0])) == \
        (int(got_bp[0][0]), int(got_bp[1][0]))


def test_auto_dispatch():
    """A CPU tensor takes banded_align; off the CPU, unit costs with band
    <= 15 go to the bit-parallel kernel's wrapper and band > 15 or
    non-unit costs to the general kernel's wrapper (a tensor on the `meta`
    device reaches each wrapper's device check without a card, and
    raises there); the general wrapper refuses bands above its largest."""
    rng = np.random.default_rng(3)
    arrays = _batch(rng, 16, 30, 40, 16)
    got = _port(tbanded.banded_align_auto, arrays, 16)
    want = _ref(rbanded.banded_align, arrays, 16)
    np.testing.assert_array_equal(got[0], want[0])
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                        device="meta") for a in arrays]
    for kw in (dict(band=16), dict(band=192), dict(band=8, sub_cost=2),
               dict(band=8, gap_cost=3)):
        with pytest.raises(ValueError, match="banded_align_general: no "
                                             "kernel for device meta"):
            tbanded.banded_align_auto(*meta, **kw)
    with pytest.raises(ValueError, match="banded_align_bp: no kernel for "
                                         "device meta"):
        tbanded.banded_align_auto(*meta, band=8)
    cpu = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="band=16"):
        banded_cuda.banded_align_bp(*cpu, band=16)
    with pytest.raises(ValueError, match="band=256"):
        banded_general_cuda._banded_general_cuda(*cpu, 256, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [1, 8, 15])
def test_kernel_matches_plain_on_card(band):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(300 + band)
    arrays = _batch(rng, 4096, 260, 276, band, n_frac=0.01)
    cpu = [torch.from_numpy(a) for a in arrays]
    before = trace.count("banded_bp")
    cost, t_end = banded_cuda.banded_align_bp(*(a.cuda() for a in cpu),
                                              band=band)
    torch.cuda.synchronize()
    assert trace.count("banded_bp") == before + 1
    want_c, want_e = banded_cuda.banded_align_bp(*cpu, band=band)
    assert torch.equal(cost.cpu(), want_c)
    assert torch.equal(t_end.cpu(), want_e)

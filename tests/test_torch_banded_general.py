"""The general banded DP: the port's plain version vs the reference, exactly.

`ops/cuda/banded_general_cuda.banded_general_plain` (the plain PyTorch
version of csrc/banded_general.cu, which a CPU tensor takes) must equal
the JAX package's Pallas kernel `banded_align_pallas` (interpret mode, as
tests/test_banded_pallas.py runs it) and its jnp `banded_align`, on cost
and t_end, at bands 16-192 and costs (1,1), (2,1), (1,3), on batches with
N codes (a query code 4 matches a target code 4 here), q_len = 0 rows and
offsets outside the feasible window; and `np_banded_oracle` on a sample.
The Pallas kernel takes batches in multiples of 128, so its call pads
with q_len = 0 rows, as the reference's dispatcher does. The
`cuda`-marked cases hold the kernel against the plain version on a card
(bands 0-255, B = 1, run_full's B = 8 shapes, short targets and edge
offsets) and skip without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.ops import banded as rbanded  # noqa: E402
from allpathslg_tpu.ops.pallas import banded_pallas as rpallas  # noqa: E402
from allpathslg_tpu_torch import trace  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import banded_general_cuda as bg  # noqa: E402

torch.set_num_threads(2)
BIG = 1 << 20
B = 100
SHAPES = {16: (40, 72), 24: (48, 90), 96: (64, 260), 192: (64, 460)}


def _batch(rng, Lq, Lt, band):
    """Targets that copy the query for half the batch (with a few edits),
    ragged lengths, N codes on both sides, q_len = 0 rows and offsets
    reaching past the feasible window [-(Lq + band), Lt + band]."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    off = rng.integers(-(Lq + band) - 5, Lt + band + 6, B).astype(np.int32)
    for i in range(0, B, 2):
        o = int(rng.integers(0, Lt - Lq))
        t[i, o:o + Lq] = q[i]
        p = rng.integers(0, Lt, int(rng.integers(0, 6)))
        t[i, p] = rng.integers(0, 4, len(p))
        off[i] = o + int(rng.integers(-band // 2, band // 2 + 1))
    q[rng.random((B, Lq)) < 0.03] = 4
    t[rng.random((B, Lt)) < 0.02] = 4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    ql[::9] = 0
    tl = rng.integers(Lq // 2, Lt + 1, B).astype(np.int32)
    q = np.where(np.arange(Lq)[None, :] < ql[:, None], q, 4).astype(np.uint8)
    return q, ql, t, tl, off


def _pallas(arrays, band, sc, gc):
    q, ql, t, tl, off = arrays
    pad = (-B) % 128
    q = np.pad(q, ((0, pad), (0, 0)), constant_values=4)
    t = np.pad(t, ((0, pad), (0, 0)), constant_values=4)
    ql, tl, off = (np.pad(x, (0, pad)) for x in (ql, tl, off))
    c, e = rpallas.banded_align_pallas(
        *(jnp.asarray(x) for x in (q, ql, t, tl, off)), band=band,
        sub_cost=sc, gap_cost=gc, interpret=True)
    return np.asarray(c)[:B], np.asarray(e)[:B]


@pytest.mark.parametrize("sc,gc", [(1, 1), (2, 1), (1, 3)])
@pytest.mark.parametrize("band", [16, 24, 96, 192])
def test_plain_matches_pallas_jnp_and_oracle(band, sc, gc):
    rng = np.random.default_rng(1000 * band + 10 * sc + gc)
    Lq, Lt = SHAPES[band]
    arrays = _batch(rng, Lq, Lt, band)
    c, e = bg.banded_align_general(*(torch.from_numpy(a) for a in arrays),
                                   band=band, sub_cost=sc, gap_cost=gc)
    assert c.dtype == e.dtype == torch.int32
    got = (c.numpy(), e.numpy())
    jc, je = rbanded.banded_align(*(jnp.asarray(a) for a in arrays),
                                  band=band, sub_cost=sc, gap_cost=gc)
    for want in ((np.asarray(jc), np.asarray(je)),
                 _pallas(arrays, band, sc, gc)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] < BIG).sum() > 30          # many problems have a path
    assert (got[0] >= BIG).sum() > 5          # and infeasible offsets die
    q, ql, t, tl, off = arrays
    for i in range(0, B, 11):
        oc, oe = rbanded.np_banded_oracle(q[i, :ql[i]], t[i, :tl[i]],
                                          int(off[i]), band, sc, gc)
        assert got[0][i] == oc
        if oc < BIG:
            assert got[1][i] == oe


def _held_on_card(cpu, band, costs=((1, 1), (2, 3))):
    """The kernel on the card == the plain version on the CPU, one launch
    a call."""
    for sc, gc in costs:
        before = trace.count("banded_general")
        cost, t_end = bg.banded_align_general(*(a.cuda() for a in cpu),
                                              band=band, sub_cost=sc,
                                              gap_cost=gc)
        torch.cuda.synchronize()
        assert trace.count("banded_general") == before + 1
        want_c, want_e = bg.banded_general_plain(*cpu, band=band,
                                                 sub_cost=sc, gap_cost=gc)
        assert torch.equal(cost.cpu(), want_c)
        assert torch.equal(t_end.cpu(), want_e)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [0, 1, 2, 15, 16, 96, 192, 255])
def test_kernel_matches_plain_on_card(band):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(2000 + band)
    _held_on_card([torch.from_numpy(a) for a in _batch(rng, 64, 460, band)],
                  band)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 128, 160, 16), (8, 64, 512, 192),
                                   (8, 128, 512, 96), (8, 128, 512, 48)])
def test_kernel_matches_plain_on_card_at_callers_shapes(shape):
    """B = 1 at band 16 (assisted) and run_full's three B = 8 patch_gaps
    batches (chip_smoke.patch_problems); then a target shorter than the
    band's K with every q_len = Lq and offsets at both edges of the
    feasible window (chip_smoke.edge_problems)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    B, Lq, Lt, band = shape
    rng = np.random.default_rng(sum(shape))
    if B == 1:
        arrays = chip_smoke.dp_problems(rng, 1, Lq, Lt, band)
    else:
        arrays = chip_smoke.patch_problems(rng, B, Lq, Lt, band)
    _held_on_card([torch.from_numpy(a) for a in arrays], band)
    edges = chip_smoke.edge_problems(rng, 512, 64, 160, band)
    _held_on_card([torch.from_numpy(a) for a in edges], band)

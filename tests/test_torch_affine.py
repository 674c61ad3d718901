"""Port affine banded DP (ops/affine.py) vs the reference.

The same numpy batches go through the reference's jnp
`affine_banded_align` and the port's torch one on the CPU: cost and t_end
must be equal, exactly. Beside tests/test_affine.py's cases, the batches
hold rows with no in-band path (the reference returns (BIG, -1)), rows
with q_len = 0 (cost 0), bands that leave the target partway down, and
bands 0 and 1; where they are small, the numpy oracle (a copy of the
reference's) holds the cost too. The `cuda`-marked case holds the card
against the CPU and skips without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.ops import affine as raff  # noqa: E402
from allpathslg_tpu_torch.ops import affine as taff  # noqa: E402

torch.set_num_threads(2)
BIG = 1 << 20


def _pack(qs, ts, offs, Lq=None, Lt=None):
    """tests/test_affine.py's _batch, as numpy arrays."""
    B = len(qs)
    Lq = Lq or max(max(len(x) for x in qs), 1)
    Lt = Lt or max(max(len(x) for x in ts), 1)
    q = np.full((B, Lq), 4, np.uint8)
    t = np.full((B, Lt), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (a, b) in enumerate(zip(qs, ts)):
        q[i, :len(a)] = a
        t[i, :len(b)] = b
        ql[i] = len(a)
        tl[i] = len(b)
    return q, ql, t, tl, np.asarray(offs, np.int32)


def _both(arrays, **kw):
    rc, re = raff.affine_banded_align(*(jnp.asarray(a) for a in arrays), **kw)
    tc, te = taff.affine_banded_align(*(torch.from_numpy(a) for a in arrays),
                                      **kw)
    assert tc.dtype == torch.int32 and te.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    return tc.numpy(), te.numpy()


def _mutated(rng, n, lt_lo=20, lt_hi=60):
    """tests/test_affine.py's random problems: a target slice with
    substitutions and one short indel."""
    qs, ts, offs = [], [], []
    for _ in range(n):
        lt = int(rng.integers(lt_lo, lt_hi))
        t = rng.integers(0, 4, lt).astype(np.uint8)
        s = int(rng.integers(0, max(lt - 15, 1)))
        e = int(rng.integers(s + 10, min(s + 40, lt) + 1))
        q = t[s:e].copy()
        for _ in range(int(rng.integers(0, 3))):
            q[rng.integers(0, len(q))] = rng.integers(0, 4)
        if rng.random() < 0.5 and len(q) > 12:
            p = int(rng.integers(2, len(q) - 2))
            if rng.random() < 0.5:
                q = np.delete(q, slice(p, p + int(rng.integers(1, 3))))
            else:
                ins = rng.integers(0, 4, int(rng.integers(1, 3))
                                   ).astype(np.uint8)
                q = np.concatenate([q[:p], ins, q[p:]])
        qs.append(q)
        ts.append(t)
        offs.append(s)
    return qs, ts, offs


def test_random_batch_equals_reference_and_oracle():
    qs, ts, offs = _mutated(np.random.default_rng(7), 40)
    cost, t_end = _both(_pack(qs, ts, offs), band=8)
    for i in range(len(qs)):
        oc, _ = taff.np_affine_oracle(qs[i], ts[i], offs[i], 8)
        assert oc == raff.np_affine_oracle(qs[i], ts[i], offs[i], 8)[0]
        assert int(cost[i]) == oc, (i, int(cost[i]), oc)
        assert (int(t_end[i]) >= 0) == (oc < BIG)


def test_one_gap_run():
    t = np.random.default_rng(3).integers(0, 4, 50).astype(np.uint8)
    q = np.concatenate([t[:20], t[23:]])
    cost, _ = _both(_pack([q], [t], [0]), band=6, sub_cost=3, gap_open=4,
                    gap_ext=1)
    assert int(cost[0]) == 4 + 3 * 1


def _edge_batch(rng, band):
    """Rows with no in-band path, q_len = 0 rows, bands that leave the
    target partway down, offsets at both ends, N codes and ragged pads."""
    qs, ts, offs = _mutated(rng, 24, 30, 70)
    Lq = max(len(x) for x in qs) + 6
    for i in range(0, 24, 6):
        offs[i] = len(ts[i]) + band + 3          # right of the target
        offs[i + 1] = -(len(qs[i + 1]) + band + 2)   # left of it
        qs[i + 2] = qs[i + 2][:0]                # q_len = 0
        offs[i + 3] = len(ts[i + 3]) - len(qs[i + 3]) // 2   # leaves it
        q = qs[i + 4].copy()
        q[::7] = 4                               # N bases in the query
        qs[i + 4] = q
        offs[i + 5] = -band                      # at the left edge
    arrays = list(_pack(qs, ts, offs, Lq=Lq))
    return qs, ts, offs, arrays


@pytest.mark.parametrize("band", [0, 1, 2, 8, 16])
def test_edges_equal_reference(band):
    qs, ts, offs, arrays = _edge_batch(np.random.default_rng(100 + band),
                                       band)
    cost, t_end = _both(arrays, band=band)
    for i in range(0, 24, 6):
        assert cost[i] == BIG and t_end[i] == -1
        assert cost[i + 1] == BIG and t_end[i + 1] == -1
        if abs(offs[i + 2]) <= band:
            assert cost[i + 2] == 0
    for i in range(len(qs)):
        oc, _ = raff.np_affine_oracle(qs[i], ts[i], offs[i], band)
        if oc < BIG:
            assert int(cost[i]) == oc, (band, i, int(cost[i]), oc)
        else:
            assert cost[i] == BIG and t_end[i] == -1


@pytest.mark.parametrize("costs", [(1, 1, 1), (2, 6, 2), (5, 0, 3)],
                         ids=["unit", "wide_open", "no_open"])
def test_costs_equal_reference(costs):
    sub, go, ge = costs
    rng = np.random.default_rng(sum(costs))
    qs, ts, offs, arrays = _edge_batch(rng, 12)
    _both(arrays, band=12, sub_cost=sub, gap_open=go, gap_ext=ge)


def test_unreachable_carries_grow_as_in_the_reference():
    """A band that leaves the target on the left for many rows: Ix grows
    by gap_ext a row past BIG in both packages; the rows that re-enter
    it cost the same."""
    rng = np.random.default_rng(11)
    B, Lq, Lt = 64, 120, 40
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    ql = rng.integers(0, Lq + 1, B).astype(np.int32)
    tl = rng.integers(0, Lt + 1, B).astype(np.int32)
    off = rng.integers(-Lq - 5, Lt + 5, B).astype(np.int32)
    cost, _ = _both([q, ql, t, tl, off], band=20, sub_cost=3, gap_open=4,
                    gap_ext=2)
    assert (cost == BIG).any() and (cost < BIG).any()


@pytest.mark.cuda
def test_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, _, arrays = _edge_batch(np.random.default_rng(5), 16)
    cpu = [torch.from_numpy(a) for a in arrays]
    want = taff.affine_banded_align(*cpu, band=16)
    got = taff.affine_banded_align(*(a.cuda() for a in cpu), band=16)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)

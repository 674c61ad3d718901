"""The word-level arithmetic of the Hopper bit-parallel DP
(allpathslg_tpu_torch/csrc/banded_bp.cu), emulated in numpy, against the
kernel's plain version (`banded_cuda.banded_align_bp_plain`) and the
reference's Pallas kernel (`banded_align_bp`, interpret mode), exactly.

The emulation follows the CUDA source step for step, vectorised over the
problems: the aligned loads of 32 bytes of a row from a flat
memory image whose rows start at any byte address (4-byte aligned words,
bytes at a row's edges) and their funnel-shift realignment; the target's bit
planes, built 32 columns at a time with the byte-parallel bit tricks and
the gather multiply; each row's Eq as a funnel shift of the two plane
words its query code names (code >= 4: the zero plane); the recurrence;
and the final scan. The `cuda`-marked case holds the kernel itself
against the plain version at the two batch shapes run_full gives it, and
skips without a card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from allpathslg_tpu.ops.pallas import banded_bp as rbp  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import banded_cuda  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BIG = 1 << 20
M32 = np.uint64(0xFFFFFFFF)
FILL = np.uint32(0x04040404)
GARBAGE = 9     # bytes outside the tensors in the memory image


def _u32(x):
    return np.asarray(x, dtype=np.uint64) & M32


def _funnel_r(lo, hi, s):
    """__funnelshift_r(lo, hi, s) for s in 0..31 (uint64 arrays)."""
    return ((hi << np.uint64(32) | lo) >> np.asarray(s, np.uint64)) & M32


class _Memory:
    """A flat byte image of one [B, L] uint8 array, its first row at byte
    address `base` (any alignment), GARBAGE around it."""

    def __init__(self, arr, base):
        B, self.L = arr.shape
        self.mem = np.concatenate([np.full(base, GARBAGE, np.uint8),
                                   arr.ravel(),
                                   np.full(64, GARBAGE, np.uint8)])
        self.row = base + np.arange(B, dtype=np.int64) * self.L

    def word(self, addr):
        """Little-endian uint32 at 4-aligned byte addresses (clipped into
        the image where a lane does not use it)."""
        a = np.clip(addr, 0, len(self.mem) - 4)
        return sum(self.mem[a + k].astype(np.uint64) << np.uint64(8 * k)
                   for k in range(4))

    def byte(self, addr):
        return self.mem[np.clip(addr, 0, len(self.mem) - 1)].astype(np.uint64)

    def load_raw(self, start):
        """load_raw: (w [B, 9], sh [B]) for 32 bytes at column `start` [B]
        of each row, from the 4-byte aligned words that cover them; bytes
        outside [0, L) read as code 4."""
        L = self.L
        a = self.row + start
        ab = a & ~np.int64(3)
        sh = a - ab
        fast = (start >= 0) & (start + 32 <= L)
        w = np.zeros((len(a), 9), np.uint64)
        for i in range(9):
            c0 = start - sh + 4 * i
            loaded = self.word(ab + 4 * i)
            inrow = (c0 >= 0) & (c0 + 4 <= L)
            outside = (c0 >= L) | (c0 + 4 <= 0)
            part = np.zeros(len(a), np.uint64)
            for k in range(4):
                c = c0 + k
                ok = (c >= 0) & (c < L)
                byte = np.where(ok, self.byte(self.row + c), 4)
                part |= byte.astype(np.uint64) << np.uint64(8 * k)
            slow = np.where(inrow, loaded,
                            np.where(outside, np.uint64(FILL), part))
            fast_w = loaded if i < 8 else np.where(sh != 0, loaded, 0)
            w[:, i] = np.where(fast, fast_w, slow)
        return w, sh


def _realign(raw):
    w, sh = raw
    return [_funnel_r(w[:, i], w[:, i + 1], 8 * sh) for i in range(8)]


def _gather_hi(x):
    """Bits 7, 15, 23, 31 of x -> bits 28..31 (the rest of x cleared)."""
    return _u32((x & np.uint64(0x80808080)) * np.uint64(0x00204081))


def _build_planes(v):
    lo = np.zeros_like(v[0])
    hi = np.zeros_like(v[0])
    big = np.zeros_like(v[0])
    for i, x in enumerate(v):
        sh = np.uint64(28 - 4 * i)
        keep = np.uint64(0xF << (4 * i))
        lo |= (_gather_hi(_u32(x << np.uint64(7))) >> sh) & keep
        hi |= (_gather_hi(_u32(x << np.uint64(6))) >> sh) & keep
        b = _u32((x & np.uint64(0x7C7C7C7C)) + np.uint64(0x7C7C7C7C)) | x
        big |= (_gather_hi(b) >> sh) & keep
    return [_u32(~(lo | hi | big)), lo & _u32(~(hi | big)),
            hi & _u32(~(lo | big)), lo & hi & _u32(~big)]


def emulate_kernel(q, q_len, t, t_len, offset, band, q_base=0, t_base=0):
    """(cost int32 [B], t_end int32 [B]) as csrc/banded_bp.cu computes
    them, q's and t's first rows at byte addresses q_base and t_base."""
    B, Lq = q.shape
    Lt = t.shape[1]
    K = 2 * band + 1
    bandmask = np.uint64(((1 << K) - 1) & ~1)
    ql = q_len.astype(np.int64)
    tl = t_len.astype(np.int64)
    off = offset.astype(np.int64)
    off_min, off_max = -(Lq + band), Lt + band
    tl = np.where((off < off_min) | (off > off_max), -1, tl)
    off = np.clip(off, off_min, off_max)
    lq_pad = (Lq + 31) // 32 * 32
    n_rows = np.where((ql >= 1) & (ql <= lq_pad), ql, 0)
    j0 = off - band
    qm, tm = _Memory(q, q_base), _Memory(t, t_base)

    P = np.zeros(B, np.uint64)
    M = np.zeros(B, np.uint64)
    s0 = np.zeros(B, np.int64)
    e0 = _build_planes(_realign(tm.load_raw(j0)))
    hi = _build_planes(_realign(tm.load_raw(j0 + 32)))
    zero = np.zeros(B, np.uint64)
    planes = [(e0[c], hi[c]) for c in range(4)] + [(zero, zero)]
    nq = qm.load_raw(np.zeros(B, np.int64))
    nt = None
    for m in range(int(-(-n_rows.max() // 32)) if B else 0):
        qw = _realign(nq)
        more = 32 * (m + 1) < n_rows
        nq_next = qm.load_raw(np.full(B, 32 * (m + 1), np.int64))
        nt = tm.load_raw(j0 + 32 * (m + 2))
        nq = tuple(np.where(more[:, None] if x.ndim == 2 else more, x, y)
                   for x, y in zip(nq_next, nq))
        rem = n_rows - 32 * m
        lo_w = np.stack([p[0] for p in planes], 1)
        hi_w = np.stack([p[1] for p in planes], 1)
        zb = np.zeros(B, np.uint64)
        # a warp of 32 problems runs its chunk for n rows: the groups of 8
        # up to its last row (32 rows when any lane fills the chunk)
        warp_rem = np.pad(rem, (0, -B % 32), constant_values=-1).reshape(
            -1, 32).max(axis=1)
        n = np.minimum(32, -(-np.repeat(warp_rem, 32)[:B] // 8) * 8)
        for i in range(32):
            code = (qw[i >> 2] >> np.uint64(8 * (i & 3))) & np.uint64(0xFF)
            idx = np.minimum(code, 4).astype(np.int64)[:, None]
            eq = _funnel_r(np.take_along_axis(lo_w, idx, 1)[:, 0],
                           np.take_along_axis(hi_w, idx, 1)[:, 0], i)
            x = eq | (M >> np.uint64(1))
            v = x | P
            c = _u32((x + v) ^ x ^ v)
            z = x | (P & c)
            d = c ^ z
            tP = c & _u32(~M) & bandmask
            tM = _u32(~c) & _u32(~P) & bandmask
            P2 = (P & _u32(~d)) | (_u32(~P) & d & tP)
            M2 = (M & _u32(~d)) | (_u32(~M) & d & tM)
            zb = np.where(i < n, _funnel_r(zb, z, 1), zb)
            live = i < rem
            P = np.where(live, P2, P)
            M = np.where(live, M2, M)
        ran = np.where(rem >= 32, 0xFFFFFFFF,
                       np.where(rem > 0, (1 << np.clip(rem, 0, 31)) - 1, 0))
        ran = _u32(ran.astype(np.uint64)
                   << np.clip(32 - n, 0, 32).astype(np.uint64))
        s0 += np.array([bin(int(b)).count("1") for b in _u32(~zb) & ran],
                       np.int64)
        new = _build_planes(_realign(nt))
        planes = [(np.where(more, planes[c][1], planes[c][0]),
                   np.where(more, new[c], planes[c][1]))
                  for c in range(4)] + [(zero, zero)]

    jbase = ql + off - band
    best = np.full(B, BIG, np.int64)
    best_end = np.full(B, -1, np.int64)
    val = s0.copy()
    for k in range(K):
        if k > 0:
            val = (val + ((P >> np.uint64(k)) & np.uint64(1)).astype(np.int64)
                   - ((M >> np.uint64(k)) & np.uint64(1)).astype(np.int64))
        jf = jbase + k
        cand = np.where((jf >= 0) & (jf <= tl), val, BIG)
        better = cand < best
        best = np.where(better, cand, best)
        best_end = np.where(better, jf, best_end)
    return (best.astype(np.int32),
            np.where(best < BIG, best_end, -1).astype(np.int32))


def _batch(rng, B, Lq, Lt, band, case):
    """Mutated-copy targets at the expected diagonal for most problems,
    shaped to exercise one corner of the kernel (`case`)."""
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    src = np.concatenate([t, np.zeros((B, Lq + band), np.uint8)], 1)
    q = src[:, band:band + Lq].copy()     # q[j] = t[j + band]
    sub = rng.random((B, Lq)) < 0.05
    q[sub] = rng.integers(0, 4, int(sub.sum()))
    for i in range(0, B, 3):               # an indel in every third read
        p = int(rng.integers(0, Lq))
        q[i, p:] = np.roll(q[i, p:], 1 if i % 2 else -1)
    ql = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    tl = np.full(B, Lt, np.int32)
    off = np.full(B, band, np.int32)
    if case == "qlen_0_and_Lq":
        ql[::3] = 0
        ql[1::3] = Lq
    elif case == "t_len_below_Lt":
        tl = rng.integers(0, Lt, B).astype(np.int32)
    elif case == "infeasible_offsets":
        n = B // 3
        off[:n] = -(Lq + band) - rng.integers(0, 5, n)
        off[n:2 * n] = Lt + band + rng.integers(0, 5, n)
    elif case == "off_diagonal":
        off = rng.integers(-Lq - band, Lt + band + 1, B).astype(np.int32)
        off[::2] = band + rng.integers(-band, band + 1, len(off[::2]))
    elif case == "query_n":
        q[rng.random((B, Lq)) < 0.05] = 4
        q[0, :] = 4
    elif case == "target_code_4":
        t[rng.random((B, Lt)) < 0.05] = 4
        t[:, Lt - 5:] = 4
    q = np.where(np.arange(Lq)[None, :] < ql[:, None], q, 4).astype(np.uint8)
    return q, ql, t, tl, off


# (band, Lq, Lt, case, q_base, t_base): Lq and Lt include sizes that are
# not multiples of 4 or 16, and the rows start at every byte alignment
CASES = [
    (0, 40, 56, "plain", 0, 0),
    (1, 40, 56, "plain", 1, 2),
    (8, 70, 93, "plain", 7, 13),
    (15, 70, 101, "plain", 11, 5),
    (8, 37, 51, "qlen_0_and_Lq", 1, 0),
    (15, 64, 96, "qlen_0_and_Lq", 0, 0),
    (8, 66, 83, "t_len_below_Lt", 2, 1),
    (4, 45, 61, "infeasible_offsets", 3, 3),
    (15, 45, 61, "infeasible_offsets", 0, 1),
    (8, 50, 77, "off_diagonal", 1, 2),
    (1, 50, 77, "off_diagonal", 0, 3),
    (8, 66, 82, "query_n", 1, 1),
    (8, 66, 82, "target_code_4", 2, 0),
    (0, 33, 35, "target_code_4", 3, 2),
]


@pytest.mark.parametrize("band,Lq,Lt,case,q_base,t_base", CASES)
def test_emulation_matches_plain_and_pallas(band, Lq, Lt, case, q_base,
                                            t_base):
    rng = np.random.default_rng(1000 + 7 * band + Lq + Lt)
    arrays = _batch(rng, 48, Lq, Lt, band, case)
    got = emulate_kernel(*arrays, band, q_base=q_base, t_base=t_base)
    plain = banded_cuda.banded_align_bp_plain(
        *(torch.from_numpy(a) for a in arrays), band=band)
    np.testing.assert_array_equal(got[0], plain[0].numpy())
    np.testing.assert_array_equal(got[1], plain[1].numpy())
    bp = rbp.banded_align_bp(*(jnp.asarray(a) for a in arrays), band=band,
                             interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(bp[0]))
    np.testing.assert_array_equal(got[1], np.asarray(bp[1]))
    if case == "infeasible_offsets":
        assert (got[0][:2 * (48 // 3)] == BIG).all()
    if case in ("plain", "qlen_0_and_Lq"):
        assert (got[0] < BIG).all()


def test_gather_and_planes_bit_tricks():
    """The gather multiply on every pattern of the four bits it gathers
    (under all other bits set), and the planes of _build_planes on every
    byte value in every position, against a byte-by-byte compare."""
    nib = np.arange(16, dtype=np.uint64)
    x = sum(((nib >> np.uint64(k)) & np.uint64(1)) << np.uint64(7 + 8 * k)
            for k in range(4)) | np.uint64(0x7F7F7F7F)
    np.testing.assert_array_equal(_gather_hi(x) >> np.uint64(28), nib)
    vals = np.arange(256, dtype=np.uint64)
    words = [vals[(np.arange(256) + 37 * i) % 256] for i in range(4)]
    x = sum(w << np.uint64(8 * k) for k, w in enumerate(words))
    e = _build_planes([x] + [np.full(256, FILL, np.uint64)] * 7)
    for c in range(4):
        want = sum((words[k] == c).astype(np.uint64) << np.uint64(k)
                   for k in range(4))
        np.testing.assert_array_equal(e[c], want)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["align_frags", "align_jumps"])
def test_kernel_at_run_full_shapes_on_card(stage):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT / "scripts"))
    import tune_banded_bp

    arrays = tune_banded_bp.run_full_batch(np.random.default_rng(5), stage)
    cpu = [torch.from_numpy(a) for a in arrays]
    cost, t_end = banded_cuda.banded_align_bp(*(a.cuda() for a in cpu),
                                              band=8)
    torch.cuda.synchronize()
    want_c, want_e = banded_cuda.banded_align_bp_plain(
        *(a.cuda() for a in cpu), band=8)
    assert torch.equal(cost, want_c)
    assert torch.equal(t_end, want_e)


def test_lane_idle_share_counts_kernel_rows():
    """chip_smoke.lane_idle_share: rows past Lq rounded up to 32, and
    q_len < 1, count as 0 rows; each warp of 32 runs its longest query."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    q_len = np.zeros(64, np.int32)
    q_len[:32] = 10
    q_len[0] = 40                      # warp 0 runs 40 rows
    q_len[32] = 97                     # > Lq = 64 rounded to 64: 0 rows
    q_len[33] = 8                      # warp 1 runs 8 rows
    rows = 40 + 31 * 10 + 8
    want = 1.0 - rows / (32 * 40 + 32 * 8)
    assert chip_smoke.lane_idle_share(q_len, 64) == pytest.approx(want)
    assert chip_smoke.lane_idle_share(np.zeros(5, np.int32), 64) == 0.0


def test_dp_capture_counts_keeps_and_restores():
    """chip_smoke.DPCapture, on the wrappers' CPU path: calls counted by
    (kernel, stage, B, Lq, Lt, band) with q_len stats, the first 2 kept
    with their outputs, and the module attributes restored on removal."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from allpathslg_tpu_torch.ops.cuda import banded_general_cuda, launches

    originals = (banded_cuda.banded_align_bp,
                 banded_general_cuda.banded_align_general)
    rng = np.random.default_rng(9)
    cap = chip_smoke.DPCapture()
    cap.install()
    try:
        with launches.stage("align_frags"):
            for _ in range(3):
                arrays = [torch.from_numpy(a) for a in
                          _batch(rng, 32, 40, 56, 8, "plain")]
                banded_cuda.banded_align_bp(*arrays, band=8)
        with launches.stage("patch_gaps"):
            arrays = [torch.from_numpy(a) for a in
                      _batch(rng, 8, 30, 90, 8, "plain")]
            banded_general_cuda.banded_align_general(*arrays, band=24)
    finally:
        cap.remove()
    assert (banded_cuda.banded_align_bp,
            banded_general_cuda.banded_align_general) == originals
    bp_key = ("banded_bp", "align_frags", 32, 40, 56, 8)
    gen_key = ("banded_general", "patch_gaps", 8, 30, 90, 24)
    assert set(cap.calls) == {bp_key, gen_key}
    assert len(cap.calls[bp_key]) == 3 and len(cap.kept[bp_key]) == 2
    assert cap.kept[gen_key][0][1] == {"band": 24, "sub_cost": 1,
                                       "gap_cost": 1}
    for key, kept in cap.kept.items():
        for inputs, kw, out in kept:
            assert int(cap.calls[key][0][0]) >= 0
            want = (banded_cuda.banded_align_bp_plain(*inputs, **kw)
                    if key[0] == "banded_bp" else
                    banded_general_cuda.banded_general_plain(*inputs, **kw))
            assert torch.equal(out[0], want[0])
            assert torch.equal(out[1], want[1])


def test_dp_bound_counts_rows_and_the_bytes_the_data_needs():
    """chip_smoke.dp_bound: rows are q_len where 1 <= q_len <= Lq; bytes
    are each problem's q_len query bytes and the target columns its band
    reaches within [0, Lt) (none for a problem with no rows), plus 20 B of
    q_len, t_len, offset, cost and t_end."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    Lq, Lt, band = 40, 50, 3
    q = torch.zeros(4, Lq, dtype=torch.uint8)
    t = torch.zeros(4, Lt, dtype=torch.uint8)
    ql = torch.tensor([10, 0, 41, 40], dtype=torch.int32)
    off = torch.tensor([3, 3, 3, 20], dtype=torch.int32)
    rows = 10 + 40
    cols = (10 + 3 + 3 - 0) + (50 - 17)   # [0, 16) and [17, 50)
    n_bytes = rows + cols + 20 * 4
    ms, by = chip_smoke.dp_bound(q, ql, t, off, band, 12, 1e9)
    by_ops = rows * 12 / 1e9 * 1e3
    by_bytes = n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert (ms, by) == ((by_ops, "operations") if by_ops >= by_bytes
                        else (by_bytes, "bytes"))
    ms, by = chip_smoke.dp_bound(q, ql, t, off, band, 12, 1e15)
    assert by == "bytes" and ms == pytest.approx(by_bytes)


def test_build_variant_rejects_a_constant_the_source_lacks():
    """ops/cuda/nvcc.build_variant refuses a NAME=VALUE whose `constexpr
    int NAME` is not in the source, before it calls nvcc."""
    from allpathslg_tpu_torch.ops.cuda import nvcc

    with pytest.raises(RuntimeError, match="kNoSuchConstant not found"):
        nvcc.build_variant("banded_bp.cu", "kNoSuchConstant=3")


@pytest.mark.parametrize("stage,mean,lo,hi", [("align_frags", 132, 0, 188),
                                              ("align_jumps", 84, 0, 100)])
def test_tuning_batches_have_run_full_q_len(stage, mean, lo, hi):
    """scripts/tune_banded_bp.run_full_batch: q_len over lo..hi with the
    mean run_full's batches have, rows past q_len code 4, offset = band =
    8 and t_len = Lt."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import tune_banded_bp

    q, ql, t, tl, off = tune_banded_bp.run_full_batch(
        np.random.default_rng(3), stage, B=8192)
    assert ql.min() == lo and ql.max() == hi
    assert abs(float(ql.mean()) - mean) < 3
    past = np.arange(q.shape[1])[None, :] >= ql[:, None]
    assert (q[past] == 4).all()
    assert (off == 8).all() and (tl == t.shape[1]).all()

"""The port's long-jump scaffolding pass == the reference's.

tests/test_longjump.py's synthetic alignlets (contigs laid on a known
genome, 10 kb long-jump pairs, given first-pass scaffolds) go through
allpathslg_tpu.scaffold.longjump.long_jump_pass and its port; the output
scaffolds and metrics must be equal, as must the coordinate helpers.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from allpathslg_tpu.scaffold import longjump as rlj  # noqa: E402
from allpathslg_tpu.scaffold.superb import Superb as RSuperb  # noqa: E402
from allpathslg_tpu_torch.scaffold import longjump as tlj  # noqa: E402
from allpathslg_tpu_torch.scaffold.superb import Superb as TSuperb  # noqa: E402

READ_LEN = 100
INSERT, SD = 10_000, 400


def _genome_layout(placements, clens):
    starts, ends, ids, rcs = [], [], [], []
    at = 0
    for item in placements:
        if isinstance(item, int):
            at += item
            continue
        cid, rc = item
        starts.append(at)
        ends.append(at + int(clens[cid]))
        ids.append(cid)
        rcs.append(rc)
        at += int(clens[cid])
    return (np.asarray(starts), np.asarray(ends), np.asarray(ids),
            np.asarray(rcs), at)


def _alignlets(placements, clens, n=500, seed=1):
    """tests/test_longjump.py's simulator: (contig, anchor, is_rc,
    aligned, pairs, read_lens)."""
    starts, ends, ids, rcs, total = _genome_layout(placements, clens)
    rng = np.random.default_rng(seed)
    recs, pair_rows = [], []

    def place(x, read_rc):
        k = np.searchsorted(ends, x, side="right")
        if k >= len(ids) or x < starts[k]:
            return None
        cid = int(ids[k])
        if not rcs[k]:
            return (cid, x - starts[k], read_rc)
        return (cid, ends[k] - 1 - x, not read_rc)

    made = 0
    while made < n:
        x = int(rng.integers(0, total - INSERT - 1))
        y = x + int(rng.normal(INSERT, SD)) - 1
        if y >= total:
            continue
        p1 = place(x, False)
        p2 = place(y, True)
        if p1 is None or p2 is None:
            continue
        i1 = len(recs)
        recs.append(p1)
        recs.append(p2)
        pair_rows.append((i1, i1 + 1))
        made += 1
    return (np.array([r[0] for r in recs], np.int32),
            np.array([r[1] for r in recs], np.int32),
            np.array([r[2] for r in recs], bool),
            np.ones(len(recs), bool),
            np.array(pair_rows, np.int32),
            np.full(len(recs), READ_LEN, np.int32))


CASES = {
    "two_scaffolds_with_gap": (
        np.array([8000, 6000, 7000, 9000], np.int64),
        [(0, False), 300, (1, False), 1500, (2, False), 250, (3, False)],
        [([0, 1], [False, False], [300], [30]),
         ([2, 3], [False, False], [250], [25])], 1),
    "rc_scaffold": (
        np.array([9000, 8000], np.int64),
        [(0, False), 1200, (1, True)],
        [([0], [False], [], []), ([1], [False], [], [])], 3),
    "three_scaffolds_two_libs": (
        np.array([5000, 7000, 6000, 8000, 4000], np.int64),
        [(0, False), 200, (1, True), 900, (2, False), 400, (3, False), 2000,
         (4, True)],
        [([0, 1], [False, True], [200], [20]),
         ([2, 3], [False, False], [400], [40]),
         ([4], [False], [], [])], 5),
}


def _as(cls, rows):
    return [cls(list(a), list(b), list(c), list(d)) for a, b, c, d in rows]


def _rows(sbs):
    return [(list(map(int, s.contig_ids)), [bool(x) for x in s.rc],
             list(map(int, s.gaps)), list(map(int, s.gap_devs)))
            for s in sbs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_long_jump_pass_equal(case):
    clens, placements, sbs, seed = CASES[case]
    al = _alignlets(placements, clens, seed=seed)
    lib_ids = None
    insert, sd = INSERT, SD
    if case == "three_scaffolds_two_libs":
        # two libraries of the same chemistry, split by pair parity
        lib_ids = (np.arange(len(al[4])) % 2).astype(np.int32)
        insert = np.array([INSERT, INSERT], np.int64)
        sd = np.array([SD, SD], np.int64)
    r_out, r_m = rlj.long_jump_pass(_as(RSuperb, sbs), clens, *al[:4],
                                    al[5], al[4], insert, sd,
                                    lib_ids=lib_ids)
    t_out, t_m = tlj.long_jump_pass(_as(TSuperb, sbs), clens, *al[:4],
                                    al[5], al[4], insert, sd,
                                    lib_ids=lib_ids)
    assert r_m == t_m
    assert _rows(r_out) == _rows(t_out)
    assert t_m["n_joins"] >= 1


def test_coordinate_helpers_equal():
    clens = np.array([100, 200, 300, 150], np.int64)
    rows = [([2, 0], [True, False], [50], [5]), ([1], [False], [], []),
            ([3], [True], [], [])]
    r = rlj.contig_placements(_as(RSuperb, rows), clens)
    t = tlj.contig_placements(_as(TSuperb, rows), clens)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(r, t))
    contig = np.array([0, 1, 2, 3, 2], np.int32)
    anchor = np.array([5, 10, 299, 0, 17], np.int32)
    is_rc = np.array([False, True, True, False, False])
    aligned = np.array([True, True, True, False, True])
    ra = rlj.to_scaffold_coords(contig, anchor, is_rc, aligned,
                                *r[:3], clens)
    ta = tlj.to_scaffold_coords(contig, anchor, is_rc, aligned,
                                *t[:3], clens)
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(ra, ta))
    meta = [([1, 0], [True, False], [70], [9]), ([2], [True], [], [])]
    rf = rlj.flatten_meta(_as(RSuperb, meta), _as(RSuperb, rows))
    tf = tlj.flatten_meta(_as(TSuperb, meta), _as(TSuperb, rows))
    assert _rows(rf) == _rows(tf)

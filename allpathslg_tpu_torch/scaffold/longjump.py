"""Long-jump scaffolding: a second MakeScaffolds pass over SCAFFOLDS (port
of allpathslg_tpu/scaffold/longjump.py).

Behavior contract (ref: src/paths/MakeScaffolds*.cc — the reference's later
scaffolding iterations admit long-jump (6-10 kb+ / Fosill ~40 kb) libraries
whose inserts span gaps regular jumps cannot; see also the ALLPATHS-LG
manual's long-jump usage and src/PairsManager.h per-library stats): treat
each first-pass scaffold as a super-contig, map long-jump read placements
from contig coordinates into scaffold coordinates, aggregate scaffold-level
links with the long-jump library's own insert distribution, and join
scaffolds with the same iterative accept/conflict-break loop.

The heavy parts (read alignment, link accumulation) are the pipeline's
alignlet aligner and the vectorized pair_links; this module is host numpy
coordinate bookkeeping on the (small) scaffold table, as in the
reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from allpathslg_tpu_torch.scaffold import links as slinks
from allpathslg_tpu_torch.scaffold import scaffolder
from allpathslg_tpu_torch.scaffold.superb import Superb


def contig_placements(scaffolds: Sequence[Superb], clens: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Per-contig placement: (scaffold id, start offset, rc, scaffold len).

    Offsets use the Superb.length coordinate system (gaps floored at 0).
    Unplaced contigs (not in any scaffold) get sid -1.
    """
    n = len(clens)
    sid = np.full(n, -1, np.int64)
    soff = np.zeros(n, np.int64)
    src = np.zeros(n, bool)
    slen = np.zeros(len(scaffolds), np.int64)
    for si, sb in enumerate(scaffolds):
        at = 0
        for i, cid in enumerate(sb.contig_ids):
            sid[cid] = si
            soff[cid] = at
            src[cid] = bool(sb.rc[i])
            at += int(clens[cid])
            if i < len(sb.gaps):
                at += max(int(sb.gaps[i]), 0)
        slen[si] = at
    return sid, soff, src, slen


def to_scaffold_coords(contig, anchor, is_rc, aligned, sid, soff, src,
                       clens):
    """Map contig-space alignlets into scaffold space."""
    contig = np.asarray(contig)
    anchor = np.asarray(anchor).astype(np.int64)
    is_rc = np.asarray(is_rc)
    aligned = np.asarray(aligned) & (sid[np.clip(contig, 0, len(sid) - 1)]
                                     >= 0)
    c = np.clip(contig, 0, len(sid) - 1)
    pr = src[c]
    a_s = np.where(pr, soff[c] + clens[c] - 1 - anchor, soff[c] + anchor)
    r_s = is_rc ^ pr
    return sid[c].astype(np.int32), a_s, r_s, aligned


def flatten_meta(meta: Sequence[Superb], scaffolds: Sequence[Superb]
                 ) -> List[Superb]:
    """Expand meta-scaffolds (over scaffold ids) into contig-level Superbs."""
    out: List[Superb] = []
    for mb in meta:
        cur = Superb([], [], [], [])
        for i, sidx in enumerate(mb.contig_ids):
            sb = scaffolds[sidx]
            ids, rcs, gaps, devs = (list(sb.contig_ids), list(sb.rc),
                                    list(sb.gaps), list(sb.gap_devs))
            if mb.rc[i]:
                ids.reverse()
                rcs = [not r for r in reversed(rcs)]
                gaps.reverse()
                devs.reverse()
            if cur.contig_ids:
                cur.gaps.append(int(mb.gaps[i - 1]))
                cur.gap_devs.append(int(mb.gap_devs[i - 1]))
            cur.contig_ids.extend(ids)
            cur.rc.extend(rcs)
            cur.gaps.extend(gaps)
            cur.gap_devs.extend(devs)
        out.append(cur)
    return out


def long_jump_pass(scaffolds: Sequence[Superb], clens: np.ndarray,
                   contig, anchor, is_rc, aligned, read_lens,
                   pairs: np.ndarray, insert, insert_sd,
                   lib_ids: np.ndarray = None,
                   cfg: scaffolder.ScaffoldConfig = None
                   ) -> Tuple[List[Superb], dict]:
    """Second scaffolding pass with long-jump pairs. Returns (scaffolds',
    metrics)."""
    clens = np.asarray(clens, np.int64)
    sid, soff, src, slen = contig_placements(scaffolds, clens)
    s_c, s_a, s_r, s_ok = to_scaffold_coords(contig, anchor, is_rc, aligned,
                                             sid, soff, src, clens)
    lg = slinks.pair_links(s_c, s_a, s_r, s_ok, read_lens, pairs, slen,
                           insert, insert_sd, lib_ids=lib_ids)
    if cfg is None:
        cfg = scaffolder.ScaffoldConfig()
    meta, n_broken = scaffolder.make_scaffolds_iterative(
        lg, len(scaffolds), slen, cfg)
    meta = scaffolder.remodel_gaps(meta, lg)
    joined = sum(1 for m in meta if len(m.contig_ids) > 1)
    out = flatten_meta(meta, scaffolds)
    return out, {"n_scaffolds_in": len(scaffolds),
                 "n_scaffolds_out": len(out),
                 "n_joins": int(sum(len(m.contig_ids) - 1 for m in meta)),
                 "n_meta_joined": joined, "n_broken": int(n_broken)}

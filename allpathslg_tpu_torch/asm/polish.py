"""Consensus polish: re-align reads, fix miscalled bases AND small indels
(port of allpathslg_tpu/asm/polish.py).

Behavior contract (ref: src/paths/FixSomeIndels.cc / FixLocal — SURVEY.md
§2.5 row 19): align reads back to the assembly, pile up per-column votes,
and repair positions where the read consensus contradicts the contig.

Substitution pass: per-column majority vote (vectorized bincount).
Indel pass: columns where the pileup DISAGREES without a clean winner are
the signature of a 1–2 bp indel (gap-free alignments shift downstream of
it, scattering the votes). For each suspect column a set of candidate
variants (1–2 bp deletion, 1–2 bp insertion of every base combo) is scored
by banded-DP realignment of the covering reads against the variant window —
all (suspect × variant × read) problems in ONE batched device dispatch —
and the minimum-total-cost variant is applied when it beats the original
by a margin.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch import trace


@dataclasses.dataclass(frozen=True)
class PolishConfig:
    min_support: int = 4        # reads covering the column
    min_frac: float = 0.8       # winning base fraction to overturn
    # indel pass
    indel_window: int = 14      # half-window around a suspect column
    indel_band: int = 6
    max_suspects: int = 512     # per polish call
    max_reads_per_suspect: int = 12
    indel_margin: int = 2       # best variant must beat original by this


def _pileup_segments(offsets: np.ndarray, codes: np.ndarray,
                     lengths: np.ndarray, al_contig, al_anchor, al_rc, al_ok,
                     seg: int = 8 << 20, chunk: int = 262144):
    """Yield (s0, s1, votes[s1-s0, 4]) over genome-position segments.

    Out-of-core pileup: alignlets are sorted by their global start
    position once, then each segment scans only its overlapping alignlet
    range, so peak memory is ~seg*32 B regardless of genome size.
    codes/lengths may be np.memmap views; rows page in per chunk."""
    total = int(offsets[-1])
    gstart = np.asarray(offsets[:-1], np.int64)
    gend = np.asarray(offsets[1:], np.int64)
    lengths = np.asarray(lengths)
    al_contig = np.asarray(al_contig)
    al_anchor = np.asarray(al_anchor)
    al_rc = np.asarray(al_rc)
    ok = np.asarray(al_ok)
    idx_all = np.nonzero(ok)[0]
    L = codes.shape[1]
    j = np.arange(L, dtype=np.int64)[None, :]
    # sort alignlets by leftmost covered global position
    anc0 = al_anchor[idx_all].astype(np.int64)
    gmin = gstart[al_contig[idx_all]] + np.where(
        al_rc[idx_all], anc0 - (lengths[idx_all].astype(np.int64) - 1), anc0)
    order = np.argsort(gmin, kind="stable")
    idx_all = idx_all[order]
    gmin = gmin[order]
    for s0 in range(0, total, seg):
        s1 = min(s0 + seg, total)
        lo = np.searchsorted(gmin, s0 - L)
        hi = np.searchsorted(gmin, s1)
        votes = np.zeros((s1 - s0) * 4, np.int64)
        for s in range(lo, hi, chunk):
            idx = idx_all[s : min(s + chunk, hi)]
            sel_len = lengths[idx][:, None]
            anchor = al_anchor[idx].astype(np.int64)[:, None]
            rc = al_rc[idx][:, None]
            tpos = np.where(rc, anchor - j, anchor + j)
            base = np.asarray(codes[idx]).astype(np.int64)
            base = np.where(rc & (base < 4), 3 - base, base)
            cs = gstart[al_contig[idx]][:, None]
            gpos = cs + tpos
            cend = gend[al_contig[idx]][:, None]
            valid = (j < sel_len) & (base < 4) & (gpos >= cs) \
                & (gpos < cend) & (gpos >= s0) & (gpos < s1)
            # bincount on (pos*4+base) is ~20x faster than np.add.at scatter
            votes += np.bincount((gpos[valid] - s0) * 4 + base[valid],
                                 minlength=(s1 - s0) * 4)
        yield s0, s1, votes.reshape(-1, 4).astype(np.int32)


def _pileup_votes(offsets: np.ndarray, codes: np.ndarray,
                  lengths: np.ndarray, al_contig, al_anchor, al_rc, al_ok,
                  chunk: int = 262144) -> np.ndarray:
    """Dense per-column base votes [total, 4] — small-assembly convenience
    wrapper over _pileup_segments (tests, toy scale)."""
    total = int(offsets[-1])
    out = np.zeros((total, 4), np.int32)
    for s0, s1, v in _pileup_segments(offsets, codes, lengths, al_contig,
                                      al_anchor, al_rc, al_ok, chunk=chunk):
        out[s0:s1] = v
    return out


def polish_contigs(flat_bases: np.ndarray, offsets: np.ndarray,
                   codes: np.ndarray, lengths: np.ndarray,
                   al_contig, al_anchor, al_rc, al_ok,
                   cfg: PolishConfig = PolishConfig()
                   ) -> Tuple[np.ndarray, int]:
    """Returns (polished flat bases, n_changed)."""
    total = int(offsets[-1])
    if total == 0 or not np.asarray(al_ok).any():
        return flat_bases, 0
    out = flat_bases.copy()
    n_changed = 0
    with trace.span("polish.pileup") as sp:
        for s0, s1, votes in _pileup_segments(offsets, codes, lengths,
                                              al_contig, al_anchor, al_rc,
                                              al_ok):
            sp.add("passes")
            support = votes.sum(1)
            winner = votes.argmax(1)
            win_n = votes[np.arange(s1 - s0), winner]
            cur = flat_bases[s0:s1].astype(np.int64)
            change = ((support >= cfg.min_support)
                      & (win_n >= cfg.min_frac * support)
                      & (winner != cur) & (cur < 4))
            out[s0:s1][change] = winner[change].astype(np.uint8)
            n_changed += int(change.sum())
    return out, n_changed


def _indel_variants(t0: np.ndarray, xs: np.ndarray) -> List[Tuple]:
    """Candidate windows: the original plus, at every candidate column x
    (window-relative), 1–2 bp deletions and single-base insertions; 2 bp
    insertions are refined in a second round at the winning column.
    Returns [(window, edit)] where edit = None | (x, kind, bases)."""
    variants = [(t0, None)]
    for x in xs:
        x = int(x)
        if x < 1 or x + 2 >= len(t0):
            continue
        variants.append((np.concatenate([t0[:x], t0[x + 1:]]),
                         (x, "del", 1)))
        variants.append((np.concatenate([t0[:x], t0[x + 2:]]),
                         (x, "del", 2)))
        for b in range(4):
            variants.append((np.concatenate(
                [t0[:x], np.asarray([b], np.uint8), t0[x:]]),
                (x, "ins", np.asarray([b], np.uint8))))
    return variants


def _ins2_variants(t0: np.ndarray, x: int) -> List[Tuple]:
    out = []
    for b1 in range(4):
        for b2 in range(4):
            out.append((np.concatenate(
                [t0[:x], np.asarray([b1, b2], np.uint8), t0[x:]]),
                (x, "ins", np.asarray([b1, b2], np.uint8))))
    return out


def polish_indels(flat_bases: np.ndarray, offsets: np.ndarray,
                  codes: np.ndarray, lengths: np.ndarray,
                  al_contig, al_anchor, al_rc, al_ok,
                  cfg: PolishConfig = PolishConfig(), device="cuda"
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Indel repair pass (ref: FixSomeIndels). Returns (new flat bases,
    new offsets, n_indels_fixed, edit_rows) where edit_rows lists
    (contig, pos, old_len, new_len) for ambiguity-table remapping. The
    variant-scoring DP runs on `device` (band 6, unit costs: the
    bit-parallel kernel on a CUDA tensor)."""
    from allpathslg_tpu_torch.asm.patch import _AlignIndex, _rc as _rcseq
    from allpathslg_tpu_torch.ops import banded

    total = int(offsets[-1])
    n_contigs = len(offsets) - 1
    if total == 0:
        return flat_bases, offsets, 0, []
    gstart = np.asarray(offsets[:-1], np.int64)
    codes = np.asarray(codes)
    lengths = np.asarray(lengths)

    # --- suspect columns: contested pileup (no clean winner) ---
    al_contig = np.asarray(al_contig)
    al_anchor = np.asarray(al_anchor)
    al_rc = np.asarray(al_rc)
    ok = np.asarray(al_ok)
    if not ok.any():
        return flat_bases, offsets, 0, []
    # contested columns, collected per segment (bounded memory at scale)
    cpos_parts, sup_parts = [], []
    with trace.span("polish.pileup") as sp:
        for s0, s1, votes in _pileup_segments(offsets, codes, lengths,
                                              al_contig, al_anchor, al_rc,
                                              ok):
            sp.add("passes")
            support = votes.sum(1)
            win_n = votes.max(1)
            contested = (support >= cfg.min_support) \
                & (win_n < cfg.min_frac * support)
            p = np.nonzero(contested)[0]
            if len(p):
                cpos_parts.append(p + s0)
                sup_parts.append(support[p])
    if not cpos_parts:
        return flat_bases, offsets, 0, []
    cpos = np.concatenate(cpos_parts)
    csup = np.concatenate(sup_parts)
    # cluster contested positions (gap <= 8 joins); suspect = cluster center
    brk = np.nonzero(np.diff(cpos) > 8)[0]
    clusters = np.split(np.arange(len(cpos)), brk + 1)
    clusters.sort(key=lambda cl: -csup[cl].sum())
    clusters = [cpos[cl] for cl in clusters[: cfg.max_suspects]]

    aidx = _AlignIndex(al_contig, al_anchor, al_rc, al_ok, lengths, n_contigs)
    w = cfg.indel_window

    def _reads_for(ci, lo_q, hi_q):
        rr = aidx.reads_on(ci)
        if len(rr) == 0:
            return []
        Lr = aidx.lengths[rr].astype(np.int64)
        rcs = aidx.rc[rr]
        anc = aidx.anchor[rr].astype(np.int64)
        rstart = np.where(rcs, anc - (Lr - 1), anc)
        rend = rstart + Lr
        cov = (rstart <= lo_q - 2) & (rend >= hi_q + 2)
        out = []
        for r in rr[cov][: cfg.max_reads_per_suspect]:
            Li = int(aidx.lengths[r])
            seq = codes[r, :Li]
            if bool(aidx.rc[r]):
                seq = _rcseq(seq)
                rs = int(aidx.anchor[r]) - (Li - 1)
            else:
                rs = int(aidx.anchor[r])
            q = seq[lo_q - rs : hi_q - rs]
            if len(q) == hi_q - lo_q:
                out.append(q)
        return out

    def _batch_costs(probs_q, probs_t, meta):
        B = len(probs_q)
        Lq = max(len(q) for q in probs_q)
        Lt = max(len(t) for t in probs_t)
        qa = np.full((B, Lq), 4, np.uint8)
        ta = np.full((B, Lt), 4, np.uint8)
        ql = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for i in range(B):
            qa[i, : len(probs_q[i])] = probs_q[i]
            ta[i, : len(probs_t[i])] = probs_t[i]
            ql[i] = len(probs_q[i])
            tl[i] = len(probs_t[i])
        dq, dql, dt, dtl = (torch.from_numpy(a).to(device)
                            for a in (qa, ql, ta, tl))
        cost, _ = banded.banded_align_auto(
            dq, dql, dt, dtl, torch.zeros(B, dtype=torch.int32, device=device),
            band=cfg.indel_band)
        cost = cost.cpu().numpy()
        tot: dict = {}
        nrd: dict = {}
        for (si, vi), c in zip(meta, cost):
            tot[(si, vi)] = tot.get((si, vi), 0) + int(c)
            nrd[(si, vi)] = nrd.get((si, vi), 0) + 1
        return tot, nrd

    # phase 1: per-cluster windows + per-position del1/del2/ins1 variants
    probs_q, probs_t, meta = [], [], []
    sus_info = []  # (ci, ws, variants, reads)
    contig_of = np.searchsorted(offsets,
                                [int(cl[len(cl) // 2]) for cl in clusters],
                                side="right") - 1
    for si, cl in enumerate(clusters):
        ci = int(contig_of[si])
        clen = int(offsets[ci + 1] - offsets[ci])
        center = int(cl[len(cl) // 2] - gstart[ci])
        ws = center - w
        we = center + w + 3
        if ws < 1 or we + 1 >= clen:
            sus_info.append(None)
            continue
        t0 = flat_bases[gstart[ci] + ws : gstart[ci] + we].copy()
        lo_x = max(int(cl[0] - gstart[ci]) - ws - 2, 1)
        hi_x = min(int(cl[-1] - gstart[ci]) - ws + 2, len(t0) - 3)
        xs = np.arange(lo_x, hi_x + 1)
        variants = _indel_variants(t0, xs)
        reads = _reads_for(ci, gstart[ci] + ws, gstart[ci] + we)
        sus_info.append((ci, ws, t0, variants, reads))
        for q in reads:
            for vi, (var, _) in enumerate(variants):
                probs_q.append(q)
                probs_t.append(var)
                meta.append((si, vi))
    if not probs_q:
        return flat_bases, offsets, 0, []
    with trace.span("polish.indel_score") as sp:
        sp.add("problems", len(probs_q))
        tot, nreads = _batch_costs(probs_q, probs_t, meta)

    # pick best per suspect; refine a winning ins1 with ins2 candidates
    edits = []  # (ci, abs_start, kind, arg)
    probs_q2, probs_t2, meta2 = [], [], []
    pending2 = {}
    for si, info in enumerate(sus_info):
        if info is None or (si, 0) not in tot:
            continue
        ci, ws, t0, variants, reads = info
        c_orig = tot[(si, 0)]
        best_vi, best_c = 0, c_orig
        for vi in range(1, len(variants)):
            c = tot.get((si, vi))
            if c is not None and c < best_c:
                best_vi, best_c = vi, c
        # banded glocal cost of a true indel is ~1 per covering read (one
        # gap), so the margin is a small absolute floor plus a per-read term
        need = max(cfg.indel_margin,
                   int(np.ceil(0.4 * nreads[(si, 0)])))
        if best_vi == 0 or best_c > c_orig - need:
            continue
        _, edit = variants[best_vi]
        x, kind, arg = edit
        if kind == "ins" and best_c > 0:
            # maybe a 2 bp insertion: refine at the winning column
            for vj, (var, e2) in enumerate(_ins2_variants(t0, x)):
                for q in reads:
                    probs_q2.append(q)
                    probs_t2.append(var)
                    meta2.append((si, vj))
            pending2[si] = (ci, ws, x, kind, arg, best_c)
        else:
            edits.append((ci, ws, edit))
    if probs_q2:
        with trace.span("polish.indel_score") as sp:
            sp.add("problems", len(probs_q2))
            tot2, _ = _batch_costs(probs_q2, probs_t2, meta2)
        for si, (ci, ws, x, kind, arg, best_c) in pending2.items():
            best2, best2_c = None, best_c
            for vj in range(16):
                c = tot2.get((si, vj))
                if c is not None and c < best2_c:
                    best2 = np.asarray([vj // 4, vj % 4], np.uint8)
                    best2_c = c
            edits.append((ci, ws, (x, "ins", best2)) if best2 is not None
                         else (ci, ws, (x, kind, arg)))
    elif pending2:
        for si, (ci, ws, x, kind, arg, best_c) in pending2.items():
            edits.append((ci, ws, (x, kind, arg)))

    if not edits:
        return flat_bases, offsets, 0, []
    # apply per contig, right-to-left (absolute position = ws + x)
    contigs = [flat_bases[offsets[i]:offsets[i + 1]].copy()
               for i in range(n_contigs)]
    by_c: dict = {}
    n_applied = 0
    edit_rows = []  # (contig, pos, old_len, new_len) for amb threading
    for (ci, ws, (x, kind, arg)) in edits:
        a = ws + x
        if kind == "del":
            by_c.setdefault(ci, []).append((a, np.zeros(0, np.uint8), int(arg)))
        else:
            by_c.setdefault(ci, []).append((a, np.asarray(arg, np.uint8), 0))
    for ci, es in by_c.items():
        seq = contigs[ci]
        # drop overlapping edits (keep leftmost of each overlap cluster)
        kept, last_end = [], -1
        for (s, var, olen) in sorted(es, key=lambda e: e[0]):
            if s > last_end + 2:
                kept.append((s, var, olen))
                last_end = s + max(olen, len(var))
        for (s, var, olen) in reversed(kept):
            seq = np.concatenate([seq[:s], var, seq[s + olen:]])
        for (s, var, olen) in kept:
            edit_rows.append((ci, s, olen, len(var)))
        n_applied += len(kept)
        contigs[ci] = seq
    new_off = np.zeros(n_contigs + 1, np.int64)
    np.cumsum([len(c) for c in contigs], out=new_off[1:])
    return np.concatenate(contigs), new_off, n_applied, edit_rows

"""Gap patching: close scaffold gaps with read evidence (port of
allpathslg_tpu/asm/patch.py).

Behavior contract (ref: src/paths/PostPatcher.cc + UnipathPatcher/
PatcherCottage — SURVEY.md §2.5 row 15): for each scaffold junction, recruit
reads hanging off the two contig ends, build the crossing sequence, validate
it, and stitch accepted patches so contigs merge (raising contig N50 toward
scaffold N50). The reference forks per-gap child processes for isolation;
here gaps are data in a batch: ALL junctions' DP validation problems are
collected first and dispatched as a handful of padded device batches
(bucketed by band), instead of the reference's one-process-per-gap fan-out.

Negative gaps (overlapping contig ends the scaffolder inferred) are closed
by direct banded alignment of the flanks.

Junction decisions are computed independently against the ORIGINAL oriented
contigs (each junction only involves its two flanking contigs' near ends,
which no other junction's merge can alter), then merges are composed
left-to-right per scaffold — equivalent to the sequential formulation but
with one device round-trip per band bucket rather than per gap.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch.ops import banded
from allpathslg_tpu_torch.scaffold.superb import Superb


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    min_cov: int = 2            # pileup support to call an extension base
    max_ext: int = 600          # longest extension attempted per side
    flank: int = 400            # recruit reads ending this close to the gap
    band: int = 12
    max_cost_frac: float = 0.05  # DP cost vs overlap length to accept
    min_anchor: int = 24        # extension must reach this far into c2
    max_shift_probes: int = 129  # cap on per-junction anchor shift probes


def _rc(seq: np.ndarray) -> np.ndarray:
    out = (3 - seq[::-1].astype(np.int32)) % 4
    out = np.where(seq[::-1] > 3, 4, out)
    return out.astype(np.uint8)


def _oriented(contig: np.ndarray, flip: bool) -> np.ndarray:
    return _rc(contig) if flip else contig


def _pileup_extension(ext_rows: List[np.ndarray], cfg: PatchConfig) -> np.ndarray:
    """Column-majority consensus of read suffixes hanging past a contig end.
    Stops at the first column with support < min_cov or a contested vote.
    Fully vectorized over columns."""
    if not ext_rows:
        return np.zeros(0, np.uint8)
    L = max(len(r) for r in ext_rows)
    M = np.full((len(ext_rows), L), 4, np.uint8)
    for i, r in enumerate(ext_rows):
        M[i, : len(r)] = r
    valid = M < 4
    counts = np.stack([((M == b) & valid).sum(0) for b in range(4)])  # [4, L]
    support = valid.sum(0)
    winner = counts.argmax(0)
    win_n = counts.max(0)
    ok = (support >= cfg.min_cov) & (win_n >= 0.7 * support)
    stop = int(np.argmin(ok)) if not ok.all() else L
    return winner[:stop].astype(np.uint8)


class _AlignIndex:
    """CSR index of accepted alignments by contig (built once per call)."""

    def __init__(self, al_contig, al_anchor, al_rc, al_ok, lengths,
                 n_contigs: int):
        ok = np.asarray(al_ok) & (np.asarray(lengths) > 0)
        self.rows = np.nonzero(ok)[0]
        c = np.asarray(al_contig)[self.rows]
        order = np.argsort(c, kind="stable")
        self.rows = self.rows[order]
        c = c[order]
        self.offsets = np.searchsorted(c, np.arange(n_contigs + 1))
        self.anchor = np.asarray(al_anchor)
        self.rc = np.asarray(al_rc)
        self.lengths = np.asarray(lengths)

    def reads_on(self, contig_id: int) -> np.ndarray:
        if contig_id >= len(self.offsets) - 1:
            return np.zeros(0, np.int64)
        return self.rows[self.offsets[contig_id]:self.offsets[contig_id + 1]]


def _hanging_suffixes(contig_id, contig_len, flip, codes, aidx: _AlignIndex,
                      cfg: PatchConfig) -> List[np.ndarray]:
    """Read suffixes extending past the oriented contig's trailing end.

    With flip=False we want reads crossing the contig's RIGHT end (fwd reads
    near the end); with flip=True, reads crossing its LEFT end, returned in
    the scaffold's (flipped) orientation. Candidate reads come from the CSR
    index; the overhang test is vectorized, only matching reads are sliced.
    """
    idx = aidx.reads_on(contig_id)
    if len(idx) == 0:
        return []
    L = aidx.lengths[idx].astype(np.int64)
    rc = aidx.rc[idx]
    a = aidx.anchor[idx].astype(np.int64)
    start = np.where(rc, a - (L - 1), a)
    end = start + L
    if not flip:
        over = end - contig_len
        keep = (over > 0) & (contig_len - start <= cfg.flank + L) \
            & (start < contig_len)
    else:
        over = -start
        keep = (over > 0) & (end >= -cfg.flank) & (end > 0)
    rows = []
    for i, ov in zip(idx[keep], over[keep]):
        Li = int(aidx.lengths[i])
        read = codes[i, :Li]
        seq = read if not bool(aidx.rc[i]) else _rc(read)
        r = seq[Li - int(ov):] if not flip else _rc(seq[: int(ov)])
        if len(r):
            rows.append(r[: cfg.max_ext])
    return rows


class _DPBatch:
    """Collects banded-DP problems; runs them in a few padded device batches
    bucketed by band (ref: the per-gap SmithWatBandedA calls of
    PostPatcher, here fused into one dispatch per bucket) on `device`:
    banded_align_auto sends band <= 15 to the bit-parallel kernel and the
    wider bands of negative junctions to the general one."""

    def __init__(self, cfg: PatchConfig, device="cuda"):
        self.cfg = cfg
        self.device = device
        self.probs: Dict[int, list] = {}

    def add(self, q: np.ndarray, t: np.ndarray, off: int, band: int,
            tag) -> None:
        self.probs.setdefault(band, []).append((q, t, int(off), tag))

    @staticmethod
    def _pad_pow2(n: int, lo: int = 16) -> int:
        p = lo
        while p < n:
            p *= 2
        return p

    def run(self) -> Dict:
        """Returns {tag: (cost, t_end)} with cost None when no in-band path."""
        out = {}
        for band, plist in self.probs.items():
            B = len(plist)
            Lq = self._pad_pow2(max(len(p[0]) for p in plist), 16)
            Lt = self._pad_pow2(max(len(p[1]) for p in plist), 16)
            Bp = self._pad_pow2(B, 8)
            q = np.full((Bp, Lq), 4, np.uint8)
            t = np.full((Bp, Lt), 4, np.uint8)
            ql = np.zeros(Bp, np.int32)
            tl = np.zeros(Bp, np.int32)
            off = np.zeros(Bp, np.int32)
            for i, (qi, ti, oi, _) in enumerate(plist):
                q[i, : len(qi)] = qi
                t[i, : len(ti)] = ti
                ql[i] = len(qi)
                tl[i] = len(ti)
                off[i] = oi
            dq, dql, dt, dtl, doff = (torch.from_numpy(a).to(self.device)
                                      for a in (q, ql, t, tl, off))
            cost, tend = banded.banded_align_auto(dq, dql, dt, dtl, doff,
                                                  band=band)
            cost = cost.cpu().numpy()
            tend = tend.cpu().numpy()
            for i, (_, _, _, tag) in enumerate(plist):
                c = int(cost[i])
                out[tag] = (None, None) if c >= (1 << 20) else (c, int(tend[i]))
        return out


def _round_band(b: int) -> int:
    """Quantize band widths (the reference's buckets: one launch each)."""
    for cand in (12, 24, 48, 96, 192):
        if b <= cand:
            return cand
    return 192


def patch_scaffold_gaps(scaffolds: List[Superb], contigs: List[np.ndarray],
                        codes: np.ndarray, lengths: np.ndarray,
                        al_contig, al_anchor, al_rc, al_ok,
                        cfg: PatchConfig = PatchConfig(), device="cuda"):
    """Attempt to close every junction of every scaffold; the DP batches
    run on `device`.

    Returns (new_contigs, new_scaffolds, n_closed). Closed junctions merge
    their two contigs into one (appended to the contig list; originals are
    dropped from scaffolds)."""
    contigs = list(contigs)
    aidx = _AlignIndex(al_contig, al_anchor, al_rc, al_ok, lengths,
                       len(contigs))

    # ---- phase 1: per-junction problem construction -----------------
    juncs = []   # (si, j, kind, aux) in scaffold order
    batch = _DPBatch(cfg, device)
    exts: Dict[Tuple[int, int], np.ndarray] = {}
    for si, sb in enumerate(scaffolds):
        for j in range(len(sb.gaps)):
            c1, f1 = sb.contig_ids[j], sb.rc[j]
            c2, f2 = sb.contig_ids[j + 1], sb.rc[j + 1]
            g, dev = sb.gaps[j], sb.gap_devs[j]
            s1 = _oriented(np.asarray(contigs[c1]), f1)
            s2 = _oriented(np.asarray(contigs[c2]), f2)
            if g < 0:
                # overlapping ends: direct flank alignment
                slack = 3 * max(dev, 4)
                A = int(max(-g - slack, cfg.min_anchor))
                A = min(A, len(s2), cfg.max_ext)
                T = min(len(s1), -g + slack + A + cfg.band)
                band = _round_band(max(cfg.band, slack + 4))
                if A >= 8 and T > A:
                    batch.add(s2[:A], s1[len(s1) - T:], T + g, band,
                              ("neg", si, j))
                    juncs.append((si, j, "neg", (A, T)))
                continue
            # positive gap: pileup extension from c1's trailing end
            ext = _pileup_extension(
                _hanging_suffixes(c1, len(contigs[c1]), f1, codes, aidx, cfg),
                cfg)
            need = g + cfg.min_anchor
            if len(ext) < need:
                continue
            exts[(si, j)] = ext
            t = s2[: cfg.min_anchor + 6 * max(dev, 4) + 2 * cfg.band]
            shifts = np.arange(-3 * max(dev, 4), 3 * max(dev, 4) + 1)
            if len(shifts) > cfg.max_shift_probes:
                shifts = np.unique(np.linspace(
                    shifts[0], shifts[-1], cfg.max_shift_probes).round()
                    .astype(np.int64))
            n_probes = 0
            for shift in shifts:
                gg = g + int(shift)
                if gg < 0 or gg + cfg.min_anchor > len(ext):
                    continue
                a = ext[gg : gg + cfg.min_anchor]
                batch.add(a, t, 0, cfg.band, ("pos", si, j, gg))
                n_probes += 1
            if n_probes:
                juncs.append((si, j, "pos", None))

    # ---- phase 2: one batched DP dispatch per band bucket ------------
    results = batch.run() if juncs else {}

    # ---- phase 3: accept + compose merges per scaffold ---------------
    # collect per-junction acceptance
    accepted: Dict[Tuple[int, int], Tuple] = {}
    pos_best: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for tag, (cost, tend) in results.items():
        if cost is None:
            continue
        if tag[0] == "pos":
            _, si, j, gg = tag
            cur = pos_best.get((si, j))
            if cur is None or cost < cur[0]:
                pos_best[(si, j)] = (cost, gg)
    for (si, j, kind, aux) in juncs:
        if kind == "neg":
            A, T = aux
            cost, tend = results.get(("neg", si, j), (None, None))
            if (cost is not None and tend is not None
                    and cost <= max(2, cfg.max_cost_frac * A)
                    and tend <= T):
                accepted[(si, j)] = ("neg", A, T, tend)
        else:
            best = pos_best.get((si, j))
            if best is not None and best[0] <= max(
                    1, cfg.max_cost_frac * cfg.min_anchor):
                accepted[(si, j)] = ("pos", best[1])

    new_scaffolds: List[Superb] = []
    n_closed = 0
    pieces: List[Tuple[int, int, bool, int, int, int, int]] = []
    # piece rows: (src_contig, dst_contig, flip, src_lo, src_hi, src_len,
    # dst_off) in ORIENTED source coords — lets the caller thread EFASTA
    # ambiguity records through the recomposition (ref: FlattenHKP).
    for si, sb in enumerate(scaffolds):
        ids = list(sb.contig_ids)
        rc = list(sb.rc)
        gaps = list(sb.gaps)
        devs = list(sb.gap_devs)
        # left-to-right composition over original junction indices
        out_ids: List[int] = []
        out_rc: List[bool] = []
        out_gaps: List[int] = []
        out_devs: List[int] = []
        cur_seq: Optional[np.ndarray] = None  # pending merged sequence
        cur_pieces: List[list] = []  # [src, flip, lo, hi, slen, dst_off]

        def _flush(j_gap=None):
            nonlocal cur_seq, cur_pieces
            contigs.append(cur_seq)
            nid = len(contigs) - 1
            out_ids.append(nid)
            out_rc.append(False)
            if j_gap is not None:
                out_gaps.append(gaps[j_gap])
                out_devs.append(devs[j_gap])
            for (src, flip, lo, hi, slen, doff) in cur_pieces:
                pieces.append((src, nid, flip, lo, hi, slen, doff))
            cur_seq = None
            cur_pieces = []

        def _cut_pieces(cut):
            kept = []
            for (src, flip, lo, hi, slen, doff) in cur_pieces:
                if doff >= cut:
                    continue
                take = min(hi - lo, cut - doff)
                kept.append([src, flip, lo, lo + take, slen, doff])
            return kept

        for j in range(len(ids)):
            s_j = _oriented(np.asarray(contigs[ids[j]]), rc[j])
            if cur_seq is None:
                cur_seq = s_j
                cur_pieces = [[ids[j], rc[j], 0, len(s_j), len(s_j), 0]]
            if j == len(ids) - 1:
                break
            acc = accepted.get((si, j))
            if acc is None:
                _flush(j)
                continue
            s2 = _oriented(np.asarray(contigs[ids[j + 1]]), rc[j + 1])
            if acc[0] == "neg":
                _, A, T, tend = acc
                cut = len(cur_seq) - T + tend
                if cut < 0 or A > len(s2):
                    _flush(j)
                    continue
                cur_pieces = _cut_pieces(cut)
                cur_pieces.append([ids[j + 1], rc[j + 1], A, len(s2),
                                   len(s2), cut])
                cur_seq = np.concatenate([cur_seq[:cut], s2[A:]])
            else:
                gg = acc[1]
                ext = exts[(si, j)]
                d = len(cur_seq) + gg
                cur_pieces.append([ids[j + 1], rc[j + 1], 0, len(s2),
                                   len(s2), d])
                cur_seq = np.concatenate([cur_seq, ext[:gg], s2])
            n_closed += 1
        if cur_seq is not None:
            _flush()
        new_scaffolds.append(Superb(out_ids, out_rc, out_gaps, out_devs))
    return contigs, new_scaffolds, n_closed, pieces

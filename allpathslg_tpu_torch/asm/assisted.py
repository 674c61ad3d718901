"""Assisted assembly: use a related ("assisting") reference genome to order,
orient, and patch an assembly (port of allpathslg_tpu/asm/assisted.py).

Behavior contract (ref: src/paths/assisted/ AssistedPatcher — SURVEY.md §2.5
long-read/assisted table): when a genome related to the one being assembled
is available, ALLPATHS-LG can use it to guide patching and scaffolding. The
assisting genome proposes contig order/orientation and gap sequence; read
evidence must confirm anything spliced into the assembly (the relative is
similar, not identical — assistance is a prior, never ground truth).

Contig placement on the assisting genome is the kmer-anchor colinearity
join of eval/accuracy.py (sorted genome kmer table + batched searchsorted,
on `device`); junction refinement is a B = 1 banded DP at band 16 (the
Hopper general kernel on a CUDA tensor); patch validation is a
kmer-membership join against the read kmer table. Orchestration over the
(small) contig set is host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch.eval.accuracy import _genome_kmer_table
from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.ops import banded
from allpathslg_tpu_torch.ops import join as ops_join
from allpathslg_tpu_torch.scaffold.superb import Superb


@dataclasses.dataclass(frozen=True)
class AssistConfig:
    K: int = 32                  # anchor kmer size
    stride: int = 100            # anchor sampling stride along contigs
    max_diag_dev: int = 40       # colinear run diagonal tolerance
    min_anchors: int = 3         # anchors required in the best run
    min_anchor_frac: float = 0.4  # best run vs all sampled anchors
    max_join_gap: int = 20_000   # max reference gap to chain across
    max_overlap: int = 1_000     # tolerated placement overlap (negative gap)
    gap_dev_frac: float = 0.25
    min_gap_dev: int = 50
    # patching
    patch_K: int = 24            # read-support kmer size
    min_patch_kmer_frac: float = 0.75  # patch windows confirmed by reads
    min_patch_count: int = 2     # read kmer count considered support
    max_patch_len: int = 5_000
    flank: int = 100             # junction refinement window
    band: int = 16               # the full search window: above 15, so the
    # general kernel, rather than a window narrowed to the bit-parallel one
    max_flank_cost_frac: float = 0.25  # DP cost vs flank len to trust junction


@dataclasses.dataclass
class Placement:
    """Best colinear placement of one contig on the assisting genome."""
    contig: int
    rc: bool
    ref_start: int       # genome coordinate of the oriented contig's base 0
    ref_end: int         # one past the oriented contig's last base
    n_anchors: int
    anchor_frac: float


def _rc_seq(seq: np.ndarray) -> np.ndarray:
    out = (3 - seq[::-1].astype(np.int32)) % 4
    return np.where(seq[::-1] > 3, 4, out).astype(np.uint8)


def _best_run(vals: np.ndarray, width: int) -> Tuple[int, int]:
    """Densest window of `vals` (sorted inside) within `width`; returns
    (count, center)."""
    if len(vals) == 0:
        return 0, 0
    v = np.sort(vals)
    j = np.searchsorted(v, v + width, side="right")
    counts = j - np.arange(len(v))
    i = int(np.argmax(counts))
    run = v[i:j[i]]
    return int(counts[i]), int(np.median(run))


def place_contigs(contigs: Sequence[np.ndarray], assist_genome: np.ndarray,
                  cfg: AssistConfig = AssistConfig(), device="cuda"
                  ) -> List[Optional[Placement]]:
    """Anchor every contig on the assisting genome; keep the densest
    colinear (orientation, diagonal) run per contig."""
    K = cfg.K
    table, upos, t_rc = _genome_kmer_table(assist_genome, K, device)
    last = table[0].shape[0] - 1
    out: List[Optional[Placement]] = []
    for ci, seq in enumerate(contigs):
        seq = np.asarray(seq, np.uint8)
        if len(seq) < K:
            out.append(None)
            continue
        dseq = torch.from_numpy(np.ascontiguousarray(seq[None, :])).to(device)
        canon, _ = kmerize.kmer_windows(dseq, K)
        fwd, _ = kmerize.kmer_windows_fwd(dseq, K)
        q_rc = ~bits.lex_eq(canon, fwd)
        P = len(seq) - K + 1
        sel = np.arange(0, P, cfg.stride)
        dsel = torch.from_numpy(sel).to(device)
        keys = [w[0, dsel] for w in canon]
        idx, found = ops_join.searchsorted_words(table, keys)
        idxs = idx.long().clamp(max=last)
        gpos = upos[idxs].cpu().numpy()
        grc = t_rc[idxs].cpu().numpy().astype(bool)
        qrc = q_rc[0, dsel].cpu().numpy().astype(bool)
        ok = found.cpu().numpy() & (gpos >= 0)
        orient = grc ^ qrc           # True: contig maps rc onto genome
        diag_f = (gpos - sel)[ok & ~orient]
        diag_r = (gpos + sel)[ok & orient]
        cf, df = _best_run(diag_f, 2 * cfg.max_diag_dev)
        cr, dr = _best_run(diag_r, 2 * cfg.max_diag_dev)
        n_best, is_rc, d = (cf, False, df) if cf >= cr else (cr, True, dr)
        if n_best < cfg.min_anchors or n_best < cfg.min_anchor_frac * len(sel):
            out.append(None)
            continue
        if is_rc:
            # contig coordinate x sits at genome position d - x + (K - 1)
            ref_end = d + K - 1 + 1
            ref_start = ref_end - len(seq)
        else:
            ref_start = d
            ref_end = d + len(seq)
        out.append(Placement(ci, is_rc, int(ref_start), int(ref_end),
                             n_best, n_best / max(len(sel), 1)))
    return out


def assist_scaffold(placements: Sequence[Optional[Placement]],
                    n_contigs: int, cfg: AssistConfig = AssistConfig()
                    ) -> List[Superb]:
    """Chain placed contigs in assisting-genome order into scaffolds; gap
    estimates come from reference coordinates. Unplaced or conflicting
    (contained/overlapping) contigs become singleton scaffolds."""
    placed = sorted((p for p in placements if p is not None),
                    key=lambda p: (p.ref_start, p.ref_end))
    scaffolds: List[Superb] = []
    cur: Optional[Superb] = None
    cur_end = 0
    in_chain = set()
    for p in placed:
        if cur is not None and p.ref_end <= cur_end:
            # contained in already-chained span: emit alone, keep the chain
            scaffolds.append(Superb([p.contig], [p.rc], [], []))
            in_chain.add(p.contig)
            continue
        gap = p.ref_start - cur_end
        if cur is not None and -cfg.max_overlap <= gap <= cfg.max_join_gap:
            cur.contig_ids.append(p.contig)
            cur.rc.append(p.rc)
            cur.gaps.append(int(gap))
            cur.gap_devs.append(max(cfg.min_gap_dev,
                                    int(cfg.gap_dev_frac * abs(gap))))
        else:
            if cur is not None:
                scaffolds.append(cur)
            cur = Superb([p.contig], [p.rc], [], [])
        cur_end = p.ref_end
        in_chain.add(p.contig)
    if cur is not None:
        scaffolds.append(cur)
    for c in range(n_contigs):
        if c not in in_chain:
            scaffolds.append(Superb([c], [False], [], []))
    return scaffolds


def _align_one(q: np.ndarray, t: np.ndarray, off: int, cfg: AssistConfig,
               device) -> Tuple[int, int]:
    """(cost, t_end) of one glocal banded alignment at cfg.band."""
    cost, tend = banded.banded_align_host(
        q[None, :], np.array([len(q)], np.int32), t[None, :],
        np.array([len(t)], np.int32), np.array([off], np.int32), cfg.band,
        device)
    return int(cost[0]), int(tend[0])


def _refine_end(oriented: np.ndarray, genome: np.ndarray, ref_end: int,
                cfg: AssistConfig, device="cuda") -> Optional[int]:
    """Exact genome coordinate where the oriented contig's tail ends."""
    F = min(cfg.flank, len(oriented))
    pad = cfg.band + cfg.max_diag_dev
    a = max(0, ref_end - F - pad)
    b = min(len(genome), ref_end + pad)
    q, t = oriented[-F:], genome[a:b]
    if len(t) < F // 2:
        return None
    cost, tend = _align_one(q, t, ref_end - F - a, cfg, device)
    if cost > cfg.max_flank_cost_frac * F:
        return None
    return a + tend


def _refine_start(oriented: np.ndarray, genome: np.ndarray, ref_start: int,
                  cfg: AssistConfig, device="cuda") -> Optional[int]:
    """Exact genome coordinate where the oriented contig's head begins
    (via the rc trick: the head is the rc tail)."""
    F = min(cfg.flank, len(oriented))
    pad = cfg.band + cfg.max_diag_dev
    a = max(0, ref_start - pad)
    b = min(len(genome), ref_start + F + pad)
    e = _refine_end_seq(_rc_seq(oriented[:F]), _rc_seq(genome[a:b]),
                        (b - a) - (ref_start + F - a), cfg, device)
    return None if e is None else b - e


def _refine_end_seq(q: np.ndarray, t: np.ndarray, off: int,
                    cfg: AssistConfig, device="cuda") -> Optional[int]:
    if len(t) < len(q) // 2 or len(q) == 0:
        return None
    cost, tend = _align_one(q, t, off, cfg, device)
    if cost > cfg.max_flank_cost_frac * len(q):
        return None
    return tend


def _patch_supported(patch: np.ndarray, read_kmers, cfg: AssistConfig
                     ) -> bool:
    """Do the reads confirm the proposed patch sequence? Fraction of patch
    K-windows present in the read kmer table with count >= min_patch_count.
    The lookup runs on the read table's device."""
    if read_kmers is None:
        return False
    K = cfg.patch_K
    if len(patch) < K:
        return True  # nothing to check; junction DP already passed
    dev = read_kmers.counts.device
    dpatch = torch.from_numpy(np.ascontiguousarray(patch[None, :])).to(dev)
    canon, valid = kmerize.kmer_windows(dpatch, K)
    keys = [w.reshape(-1) for w in canon]
    idx, found = ops_join.searchsorted_words(read_kmers.words, keys)
    safe = idx.long().clamp(max=read_kmers.counts.shape[0] - 1)
    cnt = torch.where(found, read_kmers.counts[safe], 0)
    vm = valid.reshape(-1)
    n_ok = int(((cnt >= cfg.min_patch_count) & vm).sum())
    n_valid = int(vm.sum())
    if n_valid == 0:
        return True
    return n_ok / n_valid >= cfg.min_patch_kmer_frac


def assisted_patch(scaffolds: List[Superb], contigs: List[np.ndarray],
                   assist_genome: np.ndarray,
                   placements: Sequence[Optional[Placement]],
                   read_kmers=None, cfg: AssistConfig = AssistConfig(),
                   device="cuda"
                   ) -> Tuple[List[np.ndarray], List[Superb], Dict]:
    """Close assisted-scaffold gaps with assisting-genome sequence, but only
    when (a) both junctions align to the assisting genome (banded DP on
    `device`) and (b) the read kmer table confirms the patch (the relative
    is a prior, not truth). Returns (contigs', scaffolds', metrics)."""
    pl = {p.contig: p for p in placements if p is not None}
    genome = np.asarray(assist_genome, np.uint8)
    new_contigs = [np.asarray(c, np.uint8) for c in contigs]
    out_scaffolds: List[Superb] = []
    n_closed = n_rejected = 0
    for sb in scaffolds:
        # walk junctions, greedily splicing accepted patches
        chain_ids = list(sb.contig_ids)
        chain_rc = list(sb.rc)
        gaps = list(sb.gaps)
        devs = list(sb.gap_devs)
        i = 0
        while i < len(gaps):
            c1, c2 = chain_ids[i], chain_ids[i + 1]
            p1, p2 = pl.get(c1), pl.get(c2)
            g = gaps[i]
            if (p1 is None or p2 is None or g < 0 or g > cfg.max_patch_len):
                i += 1
                continue
            o1 = _rc_seq(new_contigs[c1]) if chain_rc[i] else new_contigs[c1]
            o2 = (_rc_seq(new_contigs[c2]) if chain_rc[i + 1]
                  else new_contigs[c2])
            e1 = _refine_end(o1, genome, p1.ref_end, cfg, device)
            s2 = _refine_start(o2, genome, p2.ref_start, cfg, device)
            if e1 is None or s2 is None or s2 < e1:
                n_rejected += 1
                i += 1
                continue
            patch = genome[e1:s2]
            # read confirmation across the whole junction neighborhood
            F = min(cfg.flank, len(o1), len(o2))
            probe = np.concatenate([o1[-F:], patch, o2[:F]])
            if not _patch_supported(probe, read_kmers, cfg):
                n_rejected += 1
                i += 1
                continue
            merged = np.concatenate([o1, patch, o2])
            cid = len(new_contigs)
            new_contigs.append(merged.astype(np.uint8))
            # merged contig inherits the spanned placement so the next
            # junction of the chain can also be patched
            pl[cid] = Placement(cid, False, p1.ref_start, p2.ref_end,
                                p1.n_anchors + p2.n_anchors, 1.0)
            chain_ids[i:i + 2] = [cid]
            chain_rc[i:i + 2] = [False]
            del gaps[i], devs[i]
            n_closed += 1
        out_scaffolds.append(Superb(chain_ids, chain_rc, gaps, devs))
    metrics = {"n_patches_closed": n_closed, "n_patches_rejected": n_rejected}
    return new_contigs, out_scaffolds, metrics


def assist_assembly(contigs: List[np.ndarray], assist_genome: np.ndarray,
                    read_kmers=None, cfg: AssistConfig = AssistConfig(),
                    device="cuda"
                    ) -> Tuple[List[np.ndarray], List[Superb], Dict]:
    """Full assisted pass: place -> scaffold -> patch."""
    placements = place_contigs(contigs, assist_genome, cfg, device)
    scaffolds = assist_scaffold(placements, len(contigs), cfg)
    contigs2, scaffolds2, pm = assisted_patch(
        scaffolds, contigs, assist_genome, placements, read_kmers, cfg,
        device)
    n_placed = sum(p is not None for p in placements)
    metrics = {
        "n_contigs_placed": n_placed,
        "n_assisted_scaffolds": len(scaffolds2),
        "n_assisted_joins": sum(max(0, len(s.contig_ids) - 1)
                                for s in scaffolds),
        **pm,
    }
    return contigs2, scaffolds2, metrics

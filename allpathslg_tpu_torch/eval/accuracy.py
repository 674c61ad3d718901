"""Reference-based assembly evaluation (port of
allpathslg_tpu/eval/accuracy.py).

Behavior contract (ref: src/paths/AssemblyAccuracy.cc, ScaffoldAccuracy.cc,
UnipathEval.cc, EVALUATION=FULL): align the assembly back to a known
reference and report base accuracy, genome coverage, and misassembly
counts.

Method: kmer-anchor colinearity. Sample anchors every `stride` bases of
each contig, place each uniquely on the reference via the sorted genome
kmer table (searchsorted join), then scan anchor chains: colinear runs
(consistent diagonal, orientation) validate spans; diagonal breaks are
misassembly breakpoints; anchors absent from the reference mark
error-dense or foreign sequence. The genome table is built on `device`;
its sort is ops/sort (the Hopper radix sort on a CUDA tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.ops import join as ops_join
from allpathslg_tpu_torch.ops import segmented
from allpathslg_tpu_torch.ops import sort as ops_sort


@dataclasses.dataclass(frozen=True)
class AccuracyConfig:
    K: int = 32
    stride: int = 200
    max_diag_dev: int = 30       # anchors within a run may drift this much


def _windows(seq: np.ndarray, K: int, device):
    """(canonical words [1, P], forward words [1, P]) of one sequence."""
    flat = torch.from_numpy(np.ascontiguousarray(seq[None, :])).to(device)
    canon, valid = kmerize.kmer_windows(flat, K)
    fwd, _ = kmerize.kmer_windows_fwd(flat, K)
    return canon, valid, fwd


def _genome_kmer_table(genome: np.ndarray, K: int, device="cuda"):
    """Sorted (canonical kmer -> unique position or -1 if repeated)."""
    canon, valid, fwd = _windows(genome, K, device)
    is_rc = ~bits.lex_eq(canon, fwd)
    P = genome.shape[0] - K + 1
    pos = torch.arange(P, dtype=torch.int32, device=canon[0].device)
    vm = valid.reshape(-1)
    keys = [torch.where(vm, w.reshape(-1), bits.SENTINEL) for w in canon]
    skeys, spay = ops_sort.sort_by_words(
        keys, [pos, is_rc.reshape(-1).to(torch.int32)])
    starts = ops_sort.run_starts(skeys)
    rl = segmented.run_lengths(starts)
    # unique anchors only
    uniq = starts & (rl == 1)
    upos = torch.where(uniq, spay[0], -1)
    return skeys, upos, spay[1]


def evaluate(contig_bases: np.ndarray, offsets: np.ndarray,
             genome: np.ndarray, cfg: AccuracyConfig = AccuracyConfig(),
             device="cuda") -> Dict:
    K = cfg.K
    lens = np.diff(offsets)
    n = len(lens)
    table, upos, t_rc = _genome_kmer_table(genome, K, device)
    M = table[0].shape[0]

    n_anchors = n_placed = n_breaks = 0
    covered = np.zeros(len(genome), bool)
    for i in range(n):
        seq = contig_bases[offsets[i]:offsets[i + 1]]
        if len(seq) < K:
            continue
        canon, _, fwd = _windows(seq, K, device)
        q_rc = ~bits.lex_eq(canon, fwd)
        P = len(seq) - K + 1
        sel = np.arange(0, P, cfg.stride)
        sel_t = torch.from_numpy(sel).to(canon[0].device)
        keys = [w[0, sel_t] for w in canon]
        idx, found = ops_join.searchsorted_words(table, keys)
        idxs = idx.long().clamp(max=M - 1)
        gpos = upos[idxs].cpu().numpy()
        grc = t_rc[idxs].cpu().numpy().astype(bool)
        qrc = q_rc[0, sel_t].cpu().numpy().astype(bool)
        fnd = found.cpu().numpy() & (gpos >= 0)

        n_anchors += len(sel)
        n_placed += int(fnd.sum())
        # colinearity: diagonal per anchor (orientation-adjusted)
        orient = grc ^ qrc   # contig maps rc to genome
        diag = np.where(orient, gpos + sel, gpos - sel)
        runs = 0
        prev_d = None
        prev_o = None
        for a in range(len(sel)):
            if not fnd[a]:
                continue
            if (prev_d is None or prev_o != orient[a]
                    or abs(int(diag[a]) - prev_d) > cfg.max_diag_dev):
                runs += 1
            prev_d = int(diag[a])
            prev_o = orient[a]
            lo = max(0, int(gpos[a]) - cfg.stride)
            hi = min(len(genome), int(gpos[a]) + K + cfg.stride)
            covered[lo:hi] = True
        n_breaks += max(0, runs - 1)

    return {
        "n_contigs": int(n),
        "anchor_place_rate": round(n_placed / max(n_anchors, 1), 4),
        "misassembly_breaks": int(n_breaks),
        "genome_covered_frac": round(float(covered.mean()), 4),
    }


def estimate_insert_stats(al_contig, al_anchor, al_rc, al_ok, read_lens,
                          pairs: np.ndarray, max_insert: int = 100_000,
                          trim_sigma: float = 6.0):
    """Empirical insert-size distribution from same-contig innie pairs
    (ref: SamplePairedReadStats / SamplePairedReadDistributions ->
    IntDistribution). Returns (mean, sd, histogram).

    Robustness: chimeric or multi-mapped placements produce a long uniform
    tail of bogus separations that fattens the raw moments (and the
    histogram RemodelGaps' MLE then trusts). The estimate is therefore
    MAD-trimmed: only separations within `trim_sigma` robust-sigmas
    (1.4826*MAD) of the median contribute to the moments and the
    histogram. trim_sigma=6 keeps >99.99% of a clean Gaussian library
    while rejecting the chimeric tail."""
    contig = np.asarray(al_contig)
    anchor = np.asarray(al_anchor).astype(np.int64)
    rc = np.asarray(al_rc)
    ok = np.asarray(al_ok)

    r1, r2 = pairs[:, 0], pairs[:, 1]
    good = ok[r1] & ok[r2] & (contig[r1] == contig[r2]) & (rc[r1] != rc[r2])
    r1, r2 = r1[good], r2[good]
    # innie: fwd mate's base0 at left, rc mate's base0 at right
    left = np.where(rc[r1], anchor[r2], anchor[r1])
    right = np.where(rc[r1], anchor[r1], anchor[r2])
    ins = right - left + 1
    ins = ins[(ins > 0) & (ins < max_insert)]
    if len(ins) == 0:
        return 0.0, 0.0, np.zeros(0, np.int64)
    med = np.median(ins)
    mad = 1.4826 * np.median(np.abs(ins - med))
    if mad > 0:
        # floor the trim window: PCR-duplicate-heavy libraries (>50%
        # near-identical separations) make MAD tiny-but-nonzero, and a
        # few-bp window would discard nearly all legitimate spread
        half = max(trim_sigma * mad, 50.0)
        trimmed = ins[np.abs(ins - med) <= half]
        # sanity: if the trim would discard >20% of pairs the spread is
        # not Gaussian-plus-tail; keep the untrimmed moments instead
        if len(trimmed) >= 0.8 * len(ins):
            ins = trimmed
    hist = np.bincount(np.minimum(ins, max_insert - 1))
    return float(ins.mean()), float(ins.std()), hist


def base_error_report(contig_bases: np.ndarray, offsets: np.ndarray,
                      genome: np.ndarray, K: int = 32, window: int = 400,
                      band: int = 16, max_windows: int = 256,
                      seed: int = 0, device="cuda") -> Dict:
    """Base-level error classification via affine alignment paths (ref:
    AssemblyAccuracy's per-base error report, src/paths/AssemblyAccuracy.cc;
    gap model per src/pairwise_aligners/SmithWatAffine.cc).

    Samples anchored contig windows, affine-aligns each against its placed
    genome region with traceback (align/packalign), and classifies errors
    into substitutions vs indels. Windows whose alignment cost exceeds
    `window // 4` are counted as unaligned (misassembly-class) rather than
    polluting the base-error rates. The windows are drawn from the numpy
    generator of `seed` in the reference's order, so both packages sample
    the same windows.
    """
    from allpathslg_tpu_torch.align import packalign

    lens = np.diff(offsets)
    table, upos, t_rc = _genome_kmer_table(genome, K, device)
    M = table[0].shape[0]
    rng = np.random.default_rng(seed)

    # collect candidate (contig, pos) anchors, weighted by contig length
    cands = []
    for i in range(len(lens)):
        L = int(lens[i])
        if L < window + K:
            continue
        n_i = max(1, min(8, L // window))
        for p in rng.integers(0, L - window - K + 1, n_i):
            cands.append((i, int(p)))
    if len(cands) > max_windows:
        sel = rng.choice(len(cands), max_windows, replace=False)
        cands = [cands[int(s)] for s in sel]

    mm = opens = gapb = aligned = unplaced = 0
    for ci, p in cands:
        seq = contig_bases[offsets[ci] + p: offsets[ci] + p + window]
        canon, _, fwd = _windows(seq[:K], K, device)
        keys = [w[0, :1] for w in canon]
        idx, found = ops_join.searchsorted_words(table, keys)
        if not bool(found[0]):
            unplaced += 1
            continue
        at = idx.long().clamp(max=M - 1)
        gp = int(upos[at][0])
        if gp < 0:
            unplaced += 1
            continue
        grc = bool(t_rc[at][0])
        qrc = not bool(bits.lex_eq(canon, fwd)[0, 0])
        orient_rc = grc ^ qrc
        if orient_rc:
            # window maps to the reverse strand: align the rc of the window
            seq_al = (3 - seq[::-1]) % 4
            gstart = gp + K - window
        else:
            seq_al = seq
            gstart = gp
        lo = max(0, gstart - band)
        hi = min(len(genome), gstart + window + band)
        tgt = genome[lo:hi]
        if len(tgt) < window // 2:
            unplaced += 1
            continue
        try:
            cost, aln = packalign.affine_align_path(
                seq_al, tgt, gstart - lo, band)
        except ValueError:
            unplaced += 1
            continue
        if cost > window // 4:
            unplaced += 1
            continue
        m, o, g = aln.errors(seq_al, tgt)
        mm += m
        opens += o
        gapb += g
        aligned += window

    return {
        "eval_windows": len(cands),
        "eval_unaligned_windows": int(unplaced),
        "aligned_bases": int(aligned),
        "sub_rate": round(mm / max(aligned, 1), 6),
        "indel_rate": round(gapb / max(aligned, 1), 6),
        "base_error_rate": round((mm + gapb) / max(aligned, 1), 6),
    }

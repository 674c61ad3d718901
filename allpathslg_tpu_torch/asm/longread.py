"""Long-read (PacBio) gap patching (port of allpathslg_tpu/asm/longread.py).

Behavior contract (ref: src/paths/LongReadPostPatcher.cc + src/paths/long/
consensus machinery (MultipleAligner, ConsensusScoreModel) — SURVEY.md §2.5
long-read extensions; Ribeiro 2012 workflow): noisy long reads that anchor
on both flanks of a scaffold gap donate their crossing segment; segments
are reconciled into a consensus patch which must agree with the insert-size
expectation; accepted patches close the gap. Final base quality comes from
the subsequent short-read polish pass.

Flank anchoring is a 12-mer seed vote with coarse diagonal bins (exact
kmers survive ~15% error often enough). The reference walks every base of
every read in Python against a dict of flank kmers; here the reads' packed
12-mers are sorted once (`LongReadIndex`), each flank's kmers are looked up
in them with searchsorted, and the votes are counted per (read,
orientation, diagonal bin) with numpy. The winner is the reference's
exactly: the bin with the most votes, ties to the bin whose first vote
comes first in the reference's scan order (read position ascending, then
flank position ascending), as `max` over an insertion-ordered dict picks.
Segment reconciliation picks the medoid under batched banded-DP cost (the
band absorbing indel drift; the Hopper general kernel on a CUDA tensor);
acceptance = both flank re-alignments of the medoid within an error
budget.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from allpathslg_tpu_torch.long import consensus as lcons
from allpathslg_tpu_torch.ops import banded


@dataclasses.dataclass(frozen=True)
class LongReadConfig:
    K: int = 12
    flank: int = 500           # contig flank used for anchoring
    diag_bin: int = 64
    min_votes: int = 4
    max_err: float = 0.35      # DP cost fraction accepted vs noisy reads
    band_frac: float = 0.25    # DP band as a fraction of segment length
    max_patch: int = 20000


def _rc(seq):
    out = (3 - seq[::-1].astype(np.int32)) % 4
    return np.where(seq[::-1] > 3, 4, out).astype(np.uint8)


def _window_keys(flat: np.ndarray, starts: np.ndarray, K: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(key int64 [P], valid bool [P]) of every K-window of the
    concatenation `flat` of sequences beginning at `starts`: the 2-bit
    packed window, valid when it holds no code >= 4 and lies inside one
    sequence. P = len(flat) - K + 1 (0 when shorter)."""
    P = len(flat) - K + 1
    if P <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    codes = flat.astype(np.int64)
    bad = codes >= 4
    key = np.zeros(P, np.int64)
    for i in range(K):
        key = (key << 2) | (codes[i:i + P] & 3)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[K:] - cs[:P]) == 0
    ends = np.append(starts[1:], len(flat))
    seq_end = np.repeat(ends, ends - starts)[:P]
    valid &= np.arange(P) + K <= seq_end
    return key, valid


class LongReadIndex:
    """Every valid K-mer window of every long read in both orientations,
    sorted by packed key (stable, so equal keys stay in scan order).
    Group g = 2 * read + orientation (0 forward, 1 reverse complement)."""

    def __init__(self, long_reads: Sequence[np.ndarray], K: int):
        self.K = K
        self.reads = [np.asarray(r, np.uint8) for r in long_reads]
        seqs = []
        for r in self.reads:
            seqs.extend([r, _rc(r)])
        lens = np.array([len(s) for s in seqs], np.int64)
        starts = np.zeros(len(seqs), np.int64)
        if len(seqs):
            starts[1:] = np.cumsum(lens)[:-1]
        flat = (np.concatenate(seqs) if seqs else np.zeros(0, np.uint8))
        key, valid = _window_keys(flat, starts, K)
        at = np.nonzero(valid)[0]
        gid = np.searchsorted(starts, at, side="right") - 1
        order = np.argsort(key[at], kind="stable")
        self.keys = key[at][order]
        self.gid = gid[order]
        self.pos = (at - starts[gid])[order]
        self.max_len = int(lens.max()) if len(lens) else 0


def _anchor_all(index: LongReadIndex, flank: np.ndarray,
                cfg: LongReadConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Best (votes [G], diag [G]) of every read orientation vs `flank`;
    votes 0 where no kmer hits (the reference's `(0, None)`).
    diag = flank position - read position, at the bin's centre."""
    G = 2 * len(index.reads)
    votes = np.zeros(G, np.int64)
    diag = np.zeros(G, np.int64)
    fk, fv = _window_keys(np.asarray(flank, np.uint8),
                          np.zeros(1, np.int64), cfg.K)
    fpos = np.nonzero(fv)[0]
    fk = fk[fpos]
    lo = np.searchsorted(index.keys, fk, side="left")
    hi = np.searchsorted(index.keys, fk, side="right")
    n = hi - lo
    tot = int(n.sum())
    if tot == 0:
        return votes, diag
    # every (flank window, read window) hit: flat index into the sorted
    # read windows
    first = np.repeat(lo - np.concatenate([[0], np.cumsum(n)[:-1]]), n)
    idx = first + np.arange(tot)
    fp = np.repeat(fpos, n)
    g = index.gid[idx]
    p = index.pos[idx]
    # the reference's scan order within a read: p ascending, then fp
    order = np.lexsort((fp, p, g))
    g, p, fp = g[order], p[order], fp[order]
    b = (fp - p) // cfg.diag_bin
    boff = index.max_len // cfg.diag_bin + 2
    nb = boff + len(flank) // cfg.diag_bin + 2
    comp = g * nb + (b + boff)
    uniq, first_at, cnt = np.unique(comp, return_index=True,
                                    return_counts=True)
    ug = uniq // nb
    ub = uniq % nb - boff
    # per group: most votes, then earliest first vote
    pick = np.lexsort((first_at, -cnt, ug))
    keep = np.ones(len(pick), bool)
    keep[1:] = ug[pick][1:] != ug[pick][:-1]
    sel = pick[keep]
    votes[ug[sel]] = cnt[sel]
    diag[ug[sel]] = ub[sel] * cfg.diag_bin + cfg.diag_bin // 2
    return votes, diag


def find_gap_segments(long_reads: List[np.ndarray], s1_tail: np.ndarray,
                      s2_head: np.ndarray, cfg: LongReadConfig,
                      index: Optional[LongReadIndex] = None
                      ) -> List[np.ndarray]:
    """Crossing segments: for each long read (either orientation) anchored
    on both flanks in a consistent order, the subsequence between the end
    of flank1 and the start of flank2. `index` (of `long_reads` at cfg.K)
    is built when not given."""
    if index is None:
        index = LongReadIndex(long_reads, cfg.K)
    v1s, d1s = _anchor_all(index, s1_tail, cfg)
    v2s, d2s = _anchor_all(index, s2_head, cfg)
    f1 = len(s1_tail)
    segs = []
    for ri, read0 in enumerate(index.reads):
        for o in (0, 1):
            gi = 2 * ri + o
            v1, v2 = int(v1s[gi]), int(v2s[gi])
            if v1 == 0 or v2 == 0 or v1 < cfg.min_votes \
                    or v2 < cfg.min_votes:
                continue
            read = read0 if o == 0 else _rc(read0)
            # read position where flank1 ends / flank2 begins
            r1_end = f1 - int(d1s[gi])   # read coord of s1_tail's end
            r2_start = -int(d2s[gi])     # read coord of s2_head's start
            if r2_start <= r1_end - 200 or r2_start - r1_end > cfg.max_patch:
                continue
            a = max(0, min(len(read), r1_end))
            b = max(0, min(len(read), r2_start))
            if b < a:
                a, b = b, a  # tiny overlap from binning noise
            segs.append(read[a:b])
            break
    return segs


def consensus_patch(segs: List[np.ndarray], cfg: LongReadConfig,
                    device="cuda") -> Optional[np.ndarray]:
    """Medoid segment under pairwise banded-DP cost (the batched analog of
    the reference's consensus scoring; short-read polish finishes the
    job), refined against its stack on `device`."""
    segs = [s for s in segs if len(s) <= cfg.max_patch]
    if not segs:
        return None
    if len(segs) == 1:
        return segs[0]
    lens = np.array([len(s) for s in segs])
    med = float(np.median(lens))
    keep = [s for s in segs if abs(len(s) - med) <= 0.3 * max(med, 50) + 80]
    if not keep:
        keep = segs
    if len(keep) <= 2:
        return keep[int(np.argmin([abs(len(s) - med) for s in keep]))]

    n = len(keep)
    Lq = max(max(len(s) for s in keep), 8)
    # the full search window: bands above 15 take the general kernel
    band = min(max(16, int(cfg.band_frac * med)), 192)
    B = ((n * n + 127) // 128) * 128
    q = np.full((B, Lq), 4, np.uint8)
    t = np.full((B, Lq), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    k = 0
    for i in range(n):
        for j in range(n):
            q[k, : len(keep[i])] = keep[i]
            t[k, : len(keep[j])] = keep[j]
            ql[k], tl[k] = len(keep[i]), len(keep[j])
            k += 1
    cost, _ = banded.banded_align_host(q, ql, t, tl, np.zeros(B, np.int32),
                                       band, device)
    c = cost[: n * n].reshape(n, n).astype(np.float64)
    c[c >= (1 << 20)] = np.nan
    total = np.nansum(c, axis=1)
    medoid = keep[int(np.nanargmin(total))]
    # iterative consensus refinement against the stack (ref:
    # ConsensusScoreModel / MultipleAligner, src/paths/long/)
    refined, _ = lcons.refine_consensus(medoid, keep, [0] * len(keep),
                                        device=device)
    return refined


def close_gap_with_long_reads(s1: np.ndarray, s2: np.ndarray, gap: int,
                              dev: int, long_reads: List[np.ndarray],
                              cfg: LongReadConfig = LongReadConfig(),
                              index: Optional[LongReadIndex] = None,
                              device="cuda") -> Optional[np.ndarray]:
    """Returns the merged sequence s1+patch+s2, or None."""
    tail = s1[-cfg.flank:]
    head = s2[: cfg.flank]
    segs = find_gap_segments(long_reads, tail, head, cfg, index)
    if not segs:
        return None
    patch = consensus_patch(segs, cfg, device)
    if patch is None:
        return None
    # length sanity vs gap estimate (long reads have ~±12% length noise)
    if gap > 0 and abs(len(patch) - gap) > max(4 * dev, 0.35 * gap + 120):
        return None
    return np.concatenate([s1, patch, s2])

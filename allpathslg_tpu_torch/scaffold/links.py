"""Contig link accumulation from jump-pair alignlets.

Behavior contract (ref: src/paths/BuildUnipathLinkGraphsLG.cc and the link
half of MakeScaffolds — SURVEY.md §2.4/§3.5): every jump pair whose mates
align to different contigs contributes one link between oriented contigs
with an implied gap; links aggregate per oriented pair into (count, mean
gap, gap deviation) edges.

Orientation algebra (innie pairs after jump EC: r1 reads genome-forward at
the insert's left end, r2 genome-reverse at its right end; alignlet anchors
from align/lookup.py are the contig coordinate of READ BASE 0 for both
orientations):

  scaffold form:  A' ... gap ... B'   (both genome-forward)
  A' = A   if r1 fwd on A (o1=False)  else rc(A);   A-flag oa = o1
  B' = B   if r2 rc  on B (o2=True)   else rc(B);   B-flag ob = not o2
  s1' = o1 ? La-1-a1 : a1          (r1 base 0 in A' coords)
  t2  = o2 ? a2      : Lb-1-a2     (r2 base 0 in B' coords)
  insert = (La - s1') + gap + (t2 + 1)   →   gap = insert - (La-s1') - t2 - 1

Each physical link equals its reverse (B,¬ob)→(A,¬oa); edges canonicalize
to the smaller contig id first.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def wrap_pair_counts(contig, anchor, is_rc, aligned, read_lens,
                     pairs: np.ndarray, contig_lens: np.ndarray,
                     insert: int, insert_sd: int) -> np.ndarray:
    """Per-contig count of same-contig pairs whose geometry only works if
    the contig wraps (r1 pointing off the trailing end, mate entering the
    leading end) — evidence for circularity (ref: TagCircularScaffolds)."""
    contig = np.asarray(contig)
    anchor = np.asarray(anchor)
    is_rc = np.asarray(is_rc)
    aligned = np.asarray(aligned)
    clens = np.asarray(contig_lens).astype(np.int64)
    out = np.zeros(len(clens), np.int64)
    r1 = pairs[:, 0]
    r2 = pairs[:, 1]
    ok = aligned[r1] & aligned[r2] & (contig[r1] == contig[r2])
    r1, r2 = r1[ok], r2[ok]
    c = contig[r1]
    o1, o2 = is_rc[r1], is_rc[r2]
    a1, a2 = anchor[r1].astype(np.int64), anchor[r2].astype(np.int64)
    L = clens[c]
    # treat r1's strand as the reference orientation (innie: o2 == ~o1 needed)
    consistent = o1 != o2
    # distance from r1 base0 to the end it points at + r2's from its end
    d1 = np.where(o1, a1 + 1, L - a1)
    d2 = np.where(o2, a2 + 1, L - a2)
    # linear geometry would need d1 + d2 ≈ insert pointing inward; wrap
    # pairs have the mates near OPPOSITE ends facing out: d1 + d2 much
    # larger than insert linearly, but wrap distance = d1 + d2 - L ≈ insert
    wrap_gap = (d1 + d2) - L
    good = consistent & (np.abs(wrap_gap - insert) < 5 * max(insert_sd, 10)) \
        & (d1 + d2 > L)
    np.add.at(out, c[good], 1)
    return out


@dataclasses.dataclass
class LinkGraph:
    """Aggregated oriented links (host arrays). Edge meaning: contig a
    (reverse-complemented iff oa) is followed by contig b (rc iff ob).

    span_off/span_val (optional) keep the raw per-pair within-contig spans
    d_i per edge (CSR), so RemodelGaps can run the IntDistribution MLE
    (insert_i = d_i + gap; ref: src/paths/RemodelGaps.cc). span_lib (CSR
    parallel to span_val) records each span's library so the MLE uses that
    library's own insert distribution (ref: src/PairsManager.h per-library
    stats; multi-library scaffolding)."""
    a: np.ndarray          # int32 [E]
    b: np.ndarray          # int32 [E]
    oa: np.ndarray         # bool  [E]
    ob: np.ndarray         # bool  [E]
    n_pairs: np.ndarray    # int32 [E]
    gap_mean: np.ndarray   # float [E]
    gap_sd: np.ndarray     # float [E]
    span_off: np.ndarray = None   # int64 [E+1] CSR offsets (optional)
    span_val: np.ndarray = None   # int64 [T] within-contig spans (optional)
    span_lib: np.ndarray = None   # int32 [T] library id per span (optional)

    @property
    def n_edges(self) -> int:
        return len(self.a)

    def spans(self, ei: int) -> np.ndarray:
        if self.span_off is None:
            return np.zeros(0, np.int64)
        return self.span_val[self.span_off[ei]:self.span_off[ei + 1]]

    def span_libs(self, ei: int) -> np.ndarray:
        if self.span_off is None or self.span_lib is None:
            return np.zeros(0, np.int32)
        return self.span_lib[self.span_off[ei]:self.span_off[ei + 1]]


def pair_links(contig, anchor, is_rc, aligned, read_lens,
               pairs: np.ndarray, contig_lens: np.ndarray,
               insert, insert_sd,
               max_gap_dev: float = 5.0,
               lib_ids: np.ndarray = None) -> LinkGraph:
    """Aggregate jump-pair links into the oriented contig link graph.

    `insert`/`insert_sd` are scalars for a single library, or per-LIBRARY
    arrays combined with `lib_ids` (int [P], one library id per pair) for
    multi-library runs — each pair's implied gap then uses its own
    library's insert (ref: src/PairsManager.h per-lib insert stats feeding
    MakeScaffolds link separations)."""
    contig = np.asarray(contig)
    anchor = np.asarray(anchor)
    is_rc = np.asarray(is_rc)
    aligned = np.asarray(aligned)
    clens = np.asarray(contig_lens).astype(np.int64)

    insert_arr = np.atleast_1d(np.asarray(insert, np.int64))
    sd_arr = np.atleast_1d(np.asarray(insert_sd, np.int64))
    if lib_ids is None:
        lib_ids = np.zeros(len(pairs), np.int32)
    lib_ids = np.asarray(lib_ids, np.int64)

    r1 = pairs[:, 0]
    r2 = pairs[:, 1]
    ok = aligned[r1] & aligned[r2] & (contig[r1] != contig[r2])
    r1, r2 = r1[ok], r2[ok]
    lib = lib_ids[ok]
    p_ins = insert_arr[np.minimum(lib, len(insert_arr) - 1)]
    p_sd = sd_arr[np.minimum(lib, len(sd_arr) - 1)]
    A, B = contig[r1], contig[r2]
    o1, o2 = is_rc[r1], is_rc[r2]
    a1, a2 = anchor[r1].astype(np.int64), anchor[r2].astype(np.int64)
    La, Lb = clens[A], clens[B]

    oa = o1
    ob = ~o2
    s1p = np.where(o1, La - 1 - a1, a1)
    t2 = np.where(o2, a2, Lb - 1 - a2)
    span = (La - s1p) + t2 + 1   # within-contig part of the insert
    gap = p_ins - span

    # drop absurd implied gaps (mates far inside huge contigs w/ wrong orient)
    sane = (gap > -p_ins) & (gap < 2 * p_ins)
    A, B, oa, ob, gap = A[sane], B[sane], oa[sane], ob[sane], gap[sane]
    span = span[sane]
    lib = lib[sane]
    p_sd = p_sd[sane]

    # canonicalize: smaller contig id first (reverse edge = flip both flags
    # and swap)
    swap = B < A
    A2 = np.where(swap, B, A)
    B2 = np.where(swap, A, B)
    oa2 = np.where(swap, ~ob, oa)
    ob2 = np.where(swap, ~oa, ob)

    key = (A2.astype(np.int64) << 34) | (B2.astype(np.int64) << 2) \
        | (oa2.astype(np.int64) << 1) | ob2.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    gap_s = gap[order].astype(np.float64)
    span_s = span[order].astype(np.int64)
    lib_s = lib[order].astype(np.int32)
    sd_s = p_sd[order].astype(np.float64)
    if len(key_s) == 0:
        z = np.zeros(0)
        return LinkGraph(z.astype(np.int32), z.astype(np.int32),
                         z.astype(bool), z.astype(bool), z.astype(np.int32),
                         z, z, np.zeros(1, np.int64), np.zeros(0, np.int64),
                         np.zeros(0, np.int32))
    starts = np.ones(len(key_s), bool)
    starts[1:] = key_s[1:] != key_s[:-1]
    seg = np.cumsum(starts) - 1
    n_seg = int(seg[-1]) + 1
    cnt = np.bincount(seg, minlength=n_seg)
    gsum = np.bincount(seg, weights=gap_s, minlength=n_seg)
    g2 = np.bincount(seg, weights=gap_s ** 2, minlength=n_seg)
    mean = gsum / np.maximum(cnt, 1)
    var = g2 / np.maximum(cnt, 1) - mean ** 2
    # single-pair edges fall back to the pair's own library sd
    sd_lib = np.bincount(seg, weights=sd_s, minlength=n_seg) \
        / np.maximum(cnt, 1)
    sd = np.where(cnt > 1, np.sqrt(np.maximum(var, 1.0)), sd_lib)

    ks = key_s[starts]
    span_off = np.zeros(n_seg + 1, np.int64)
    np.cumsum(cnt, out=span_off[1:])
    return LinkGraph(
        a=(ks >> 34).astype(np.int32),
        b=((ks >> 2) & ((1 << 32) - 1)).astype(np.int32),
        oa=((ks >> 1) & 1).astype(bool),
        ob=(ks & 1).astype(bool),
        n_pairs=cnt.astype(np.int32),
        gap_mean=mean,
        gap_sd=sd / np.sqrt(np.maximum(cnt, 1)),
        span_off=span_off,
        span_val=span_s,
        span_lib=lib_s,
    )

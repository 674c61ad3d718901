"""Repeat resolution by read threading — the localization core.

Behavior contract (ref: src/paths/LocalizeReadsLG.cc + MergeNeighborhoods*,
SURVEY.md §2.5 rows 13-14 and §3.4): the reference picks seed unipaths, does
thousands of per-seed local mini-assemblies (recruit reads via placements,
walk fragment inserts across repeats, pop bubbles) and glues the local
graphs back together. The *effect* is that read and insert evidence resolves
graph junctions that pure K-mer adjacency cannot.

TPU-first recast (SURVEY.md §7.2 step 7): instead of per-seed process
fan-out (a CPU-era memory workaround), run the same evidence globally and
batched:

  1. every (filled) read is pathed through the unipath graph on device
     (graph/pathsdb.py) — filled fragments span whole inserts, so their
     paths ARE the reference's "insert walks";
  2. adjacency edges never crossed by any read are deleted (the reference's
     local graphs simply never contain them);
  3. a repeat unipath whose read threads pair its in-edges to its out-edges
     one-to-one is replicated per pairing, splitting the junction — the
     global, vectorized equivalent of per-neighborhood repeat resolution.

The surviving simplified graph then merges into contigs via
graph/cleanup.py (the MergeNeighborhoods analog).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from allpathslg_tpu_torch.graph.pathsdb import ReadPaths, pack_edges
from allpathslg_tpu_torch.graph.unipath import UniGraph, Unipaths


@dataclasses.dataclass(frozen=True)
class LocalizeConfig:
    min_edge_support: int = 1      # reads that must cross an edge to keep it
    min_thread_support: int = 2    # threads to accept an (in,out) pairing
    max_rounds: int = 8            # threading rounds (each may expose more)
    max_repeat_kmers: int = 400    # only thread repeats shorter than a read/insert


def edge_support(g: UniGraph, rp: ReadPaths) -> np.ndarray:
    """# reads crossing each adjacency edge (rc-canonicalized).

    Vectorized: sorted searchsorted join of the graph's canonical edge keys
    against the observed transition table (no per-edge Python)."""
    from allpathslg_tpu_torch.graph import pathsdb as pdb
    edges, counts = pdb.transitions(rp)
    tkey = pack_edges(edges[:, 0], edges[:, 1].astype(bool),
                      edges[:, 2], edges[:, 3].astype(bool))
    order = np.argsort(tkey)
    tkey = tkey[order]
    tcnt = counts[order]
    kf = pack_edges(g.a, g.fa, g.b, g.fb)
    kr = pack_edges(g.b, ~g.fb, g.a, ~g.fa)
    kc = np.minimum(kf, kr)
    pos = np.searchsorted(tkey, kc)
    hit = (pos < len(tkey))
    safe = np.minimum(pos, max(len(tkey) - 1, 0))
    hit &= (tkey[safe] == kc) if len(tkey) else False
    out = np.zeros(len(kc), np.int32)
    out[hit] = tcnt[safe[hit]]
    return out


def filter_unsupported_edges(g: UniGraph, support: np.ndarray,
                             cfg: LocalizeConfig) -> Tuple[UniGraph, int]:
    """Drop adjacency edges no read crosses — but never disconnect a node:
    an unsupported edge is kept if it is the only out-edge of its source
    orientation or the only in-edge of its target orientation.

    Vectorized greedy (VERDICT r2 Next #7): each round recomputes oriented
    degrees by bincount over factorized endpoint keys and drops, per
    out-group and in-group, at most one candidate (its minimum-index one),
    so no group is ever emptied. Rounds repeat until fixpoint — bounded by
    the max candidate count within any group (node degree), with every
    round a handful of O(E) array passes instead of per-edge Python."""
    E = len(g.a)
    if E == 0:
        return g, 0
    ko = g.a.astype(np.int64) * 2 + g.fa
    ki = g.b.astype(np.int64) * 2 + g.fb
    uo, inv_o = np.unique(ko, return_inverse=True)
    ui, inv_i = np.unique(ki, return_inverse=True)
    keep = np.ones(E, bool)
    unsup = np.asarray(support) < cfg.min_edge_support
    idx = np.arange(E)
    while True:
        outdeg = np.bincount(inv_o[keep], minlength=len(uo))
        indeg = np.bincount(inv_i[keep], minlength=len(ui))
        cand = keep & unsup & (outdeg[inv_o] > 1) & (indeg[inv_i] > 1)
        if not cand.any():
            break
        # one drop per group per round: the min-index candidate of both
        # its out-group and its in-group
        min_o = np.full(len(uo), E, np.int64)
        min_i = np.full(len(ui), E, np.int64)
        np.minimum.at(min_o, inv_o[cand], idx[cand])
        np.minimum.at(min_i, inv_i[cand], idx[cand])
        chosen = cand & (min_o[inv_o] == idx) & (min_i[inv_i] == idx)
        if not chosen.any():
            # every remaining candidate ties with a different group's
            # minimum; break the deadlock by accepting out-group minima
            # whose in-group still has a kept non-candidate edge
            safe_in = indeg[inv_i] - np.bincount(
                inv_i[cand], minlength=len(ui))[inv_i] >= 1
            chosen = cand & (min_o[inv_o] == idx) & safe_in
            if not chosen.any():
                break
        keep &= ~chosen
    n_drop = int(E - keep.sum())
    return UniGraph(g.a[keep], g.fa[keep], g.b[keep], g.fb[keep]), n_drop


def _thread_counts(rp: ReadPaths):
    """Triples (prev, mid, next) with contiguous windows, keyed on the
    mid unipath; flags in UniGraph *flip* convention, mid normalized to
    flip=False (forward). Returns an int64 array [T, 6] of unique rows
    (m, a, fa, b, fb, count) — fully vectorized."""
    off = rp.offsets
    T = len(rp.uid)
    empty = np.zeros((0, 6), np.int64)
    entry_read = np.repeat(np.arange(rp.n_reads), np.diff(off))
    if T < 3:
        return empty
    i = np.arange(T - 2)
    same = (entry_read[i] == entry_read[i + 2])
    contig = (rp.leave[i] + 1 == rp.enter[i + 1]) & \
             (rp.leave[i + 1] + 1 == rp.enter[i + 2])
    idx = i[same & contig]
    if len(idx) == 0:
        return empty
    # vectorized normalization (mid forced forward by rc'ing the triple)
    a, fa = rp.uid[idx], ~rp.fwd[idx]
    m, fm = rp.uid[idx + 1], ~rp.fwd[idx + 1]
    b, fb = rp.uid[idx + 2], ~rp.fwd[idx + 2]
    na = np.where(fm, b, a)
    nfa = np.where(fm, ~fb, fa)
    nb = np.where(fm, a, b)
    nfb = np.where(fm, ~fa, fb)
    rows = np.stack([m.astype(np.int64), na.astype(np.int64),
                     nfa.astype(np.int64), nb.astype(np.int64),
                     nfb.astype(np.int64)], axis=1)
    uniq, counts = np.unique(rows, axis=0, return_counts=True)
    return np.concatenate([uniq, counts[:, None]], axis=1)


def thread_repeats(ups: Unipaths, g: UniGraph, rp: ReadPaths,
                   cfg: LocalizeConfig = LocalizeConfig(),
                   return_rewires: bool = False):
    """Split repeat junctions whose in/out edges are paired one-to-one by
    read threads. Returns (ups', g', n_split) — with return_rewires, a
    4th element: int64 [R, 6] rows (m, a, fa, b, fb, cid) recording which
    split copy consumed each (in, out) pairing, for revise_paths.

    A repeat unipath m (indeg>1 and outdeg>1 in fwd orientation) splits when
    every in-edge and every out-edge participates in exactly one supported
    (in, out) thread pair; m is replicated once per pair, each copy wired to
    its (in, out). Unthreadable junctions are left intact (honest fallback:
    they stay contig breaks, as in the reference when insert walking fails).
    """
    votes = _thread_counts(rp)
    votes = votes[votes[:, 5] >= cfg.min_thread_support]
    n = ups.n

    # deduped edge table (the UniGraph list may already hold mirror rows)
    def _pack4(a, fa, b, fb):
        return (np.asarray(a, np.int64) << 33) | \
            (np.asarray(fa, np.int64) << 32) | \
            (np.asarray(b, np.int64) << 1) | np.asarray(fb, np.int64)

    ekey = np.unique(_pack4(g.a, g.fa, g.b, g.fb))
    ea = (ekey >> 33).astype(np.int64)
    efa = ((ekey >> 32) & 1).astype(bool)
    eb = ((ekey >> 1) & ((1 << 31) - 1)).astype(np.int64)
    efb = (ekey & 1).astype(bool)

    # mirror-closed oriented adjacency, deduped: rows (src,fs,dst,fd)
    akey = np.unique(np.concatenate([
        _pack4(ea, efa, eb, efb), _pack4(eb, ~efb, ea, ~efa)]))
    asrc = (akey >> 33)
    afs = ((akey >> 32) & 1).astype(bool)
    adst = ((akey >> 1) & ((1 << 31) - 1))
    afd = (akey & 1).astype(bool)

    # oriented degrees of every (node, False) mid form
    okey = asrc * 2 + afs                  # out-edges keyed on source
    ikey = adst * 2 + afd                  # in-edges keyed on target
    outdeg = np.bincount(okey, minlength=2 * n)
    indeg = np.bincount(ikey, minlength=2 * n)

    # --- vectorized qualification of candidate mids -----------------------
    M, A, FA, B, FB = (votes[:, 0], votes[:, 1], votes[:, 2].astype(bool),
                       votes[:, 3], votes[:, 4].astype(bool))
    akey_sorted = akey   # already sorted by np.unique
    def _is_edge(a, fa, b, fb):
        k = _pack4(a, fa, b, fb)
        p = np.searchsorted(akey_sorted, k)
        p = np.minimum(p, max(len(akey_sorted) - 1, 0))
        return (len(akey_sorted) > 0) & (akey_sorted[p] == k)

    pair_in_ok = _is_edge(A, FA, M, np.zeros(len(M), bool))
    pair_out_ok = _is_edge(M, np.zeros(len(M), bool), B, FB)
    row_ok = pair_in_ok & pair_out_ok & (A != M) & (B != M)

    # per-mid aggregates over qualifying rows
    npairs = np.bincount(M[row_ok], minlength=n)
    # duplicate in/out usage inside a mid's pairs
    in_rows = np.unique(np.stack([M[row_ok], A[row_ok],
                                  FA[row_ok].astype(np.int64)], 1), axis=0)
    out_rows = np.unique(np.stack([M[row_ok], B[row_ok],
                                   FB[row_ok].astype(np.int64)], 1), axis=0)
    n_in_used = np.bincount(in_rows[:, 0], minlength=n)
    n_out_used = np.bincount(out_rows[:, 0], minlength=n)
    bad_row_mid = np.unique(M[~row_ok]) if (~row_ok).any() else \
        np.zeros(0, np.int64)
    mids = np.arange(n)
    mid_out = outdeg[mids * 2]
    mid_in = indeg[mids * 2]
    qual = (npairs >= 2) & (mid_in >= 2) & (mid_out >= 2) \
        & (npairs == mid_in) & (npairs == mid_out) \
        & (n_in_used == npairs) & (n_out_used == npairs) \
        & (np.asarray(ups.kmer_counts)[:n] <= cfg.max_repeat_kmers)
    qual[bad_row_mid] = False   # a vote row that is not a current edge or
    # is a self-loop disqualifies its mid this round (evidence vs graph
    # mismatch — same conservative outcome as the reference's walk failure)

    def _ret(u, gg, k, rw):
        if return_rewires:
            return u, gg, k, (np.asarray(rw, np.int64).reshape(-1, 6)
                              if len(rw) else np.zeros((0, 6), np.int64))
        return u, gg, k

    cand_mids = np.flatnonzero(qual)
    if len(cand_mids) == 0:
        return _ret(ups, UniGraph(ea.astype(np.int32), efa,
                                  eb.astype(np.int32), efb), 0, [])

    # --- apply splits (small loop over qualifying mids only) --------------
    order = np.argsort(M, kind="stable")
    Ms = M[order]
    grp_start = np.searchsorted(Ms, cand_mids, side="left")
    grp_end = np.searchsorted(Ms, cand_mids, side="right")

    new_edges: List[Tuple[int, bool, int, bool]] = []
    rewires: List[Tuple[int, int, int, int, int, int]] = []
    split_mids: List[int] = []
    split_touched = set()
    kcnt = np.asarray(ups.kmer_counts)
    mcov = ups.mean_cov
    new_seq_src: List[int] = []       # source unipath id per appended copy
    new_kcnt: List[int] = []
    new_mcov: List[float] = []
    next_id = n
    n_split = 0
    mcov_scaled = None if mcov is None else np.array(mcov, np.float32)
    for m, s, e in zip(cand_mids, grp_start, grp_end):
        rows = order[s:e]
        rows = rows[row_ok[order[s:e]]]
        if int(m) in split_touched:
            continue
        nbrs = set(A[rows].tolist()) | set(B[rows].tolist())
        if split_touched & nbrs:
            continue  # neighbor already rewired; retry next round
        for i_r, r in enumerate(rows):
            if i_r == 0:
                # the FIRST pairing reuses the original mid: all its old
                # edges are dropped below, so a fresh copy for every
                # pairing would leave the mid as an isolated node that
                # merge_contigs then emits as a spurious duplicate contig
                cid = int(m)
                if mcov_scaled is not None:
                    mcov_scaled[m] = float(mcov[m]) / max(len(rows), 1)
            else:
                cid = next_id
                next_id += 1
                new_seq_src.append(int(m))
                new_kcnt.append(int(kcnt[m]))
                if mcov is not None:
                    new_mcov.append(float(mcov[m]) / max(len(rows), 1))
            new_edges.append((int(A[r]), bool(FA[r]), cid, False))
            new_edges.append((cid, False, int(B[r]), bool(FB[r])))
            rewires.append((int(m), int(A[r]), int(FA[r]),
                            int(B[r]), int(FB[r]), cid))
        split_touched.add(int(m))
        split_touched |= nbrs
        split_mids.append(int(m))
        n_split += 1

    if n_split == 0:
        return _ret(ups, UniGraph(ea.astype(np.int32), efa,
                                  eb.astype(np.int32), efb), 0, [])

    # drop ALL edges incident to a split mid: perfect pairing means its
    # in/out sets are exactly the threaded ones, and self-loops were
    # excluded, so incidence == membership in the removed junction
    smask = np.zeros(n, bool)
    smask[split_mids] = True
    keep = ~(smask[ea] | smask[eb])
    ka = list(ea[keep]) + [t[0] for t in new_edges]
    kfa = list(efa[keep]) + [t[1] for t in new_edges]
    kb = list(eb[keep]) + [t[2] for t in new_edges]
    kfb = list(efb[keep]) + [t[3] for t in new_edges]

    # append split copies' sequences via vectorized gather
    lens = np.diff(ups.offsets)
    src = np.asarray(new_seq_src, np.int64)
    add_total = int(lens[src].sum())
    new_bases = np.empty(len(ups.bases) + add_total, np.uint8)
    new_bases[:len(ups.bases)] = ups.bases
    offsets = np.zeros(n + len(src) + 1, np.int64)
    offsets[:n + 1] = ups.offsets
    at = len(ups.bases)
    for i, sid in enumerate(src):   # few split copies; each a memcpy
        L = int(lens[sid])
        new_bases[at:at + L] = \
            ups.bases[ups.offsets[sid]:ups.offsets[sid] + L]
        at += L
        offsets[n + i + 1] = at
    ups2 = Unipaths(
        bases=new_bases,
        offsets=offsets,
        kmer_counts=np.concatenate([kcnt, np.asarray(new_kcnt, np.int32)]),
        mean_cov=None if mcov is None else np.concatenate(
            [mcov_scaled, np.asarray(new_mcov, np.float32)]))
    g2 = UniGraph(np.asarray(ka, np.int32), np.asarray(kfa, bool),
                  np.asarray(kb, np.int32), np.asarray(kfb, bool))
    return _ret(ups2, g2, n_split, rewires)


def thread_repeats_partial(ups: Unipaths, g: UniGraph, rp: ReadPaths,
                           cfg: LocalizeConfig = LocalizeConfig(),
                           margin: float = 3.0,
                           return_rewires: bool = False):
    """Pull apart DOMINANT (in, out) pairings at junctions the perfect
    matcher leaves intact (ref: SupportedHyperBasevector::PullApart handles
    the clean 2-in/2-out case; real data leaves junctions where only SOME
    pairings are resolved — VERDICT r2 Next #9 "partial pairings with
    support margins").

    A vote row (m, in, out, c) is dominant when c >= min_thread_support AND
    c >= margin x the best competing row sharing its in-edge or its
    out-edge. Each dominant row splits off a copy of m wired (in -> copy ->
    out); the consumed in/out edges leave the original m, which stays in
    place with its residual (ambiguous) edges. Returns (ups', g', n_split).
    """
    def _ret(u, gg, k, rw):
        if return_rewires:
            return u, gg, k, (np.asarray(rw, np.int64).reshape(-1, 6)
                              if len(rw) else np.zeros((0, 6), np.int64))
        return u, gg, k

    votes = _thread_counts(rp)
    if len(votes) == 0:
        return _ret(ups, g, 0, [])
    n = ups.n

    def _pack4(a, fa, b, fb):
        return (np.asarray(a, np.int64) << 33) | \
            (np.asarray(fa, np.int64) << 32) | \
            (np.asarray(b, np.int64) << 1) | np.asarray(fb, np.int64)

    ekey = np.unique(_pack4(g.a, g.fa, g.b, g.fb))
    ea = (ekey >> 33).astype(np.int64)
    efa = ((ekey >> 32) & 1).astype(bool)
    eb = ((ekey >> 1) & ((1 << 31) - 1)).astype(np.int64)
    efb = (ekey & 1).astype(bool)
    akey = np.unique(np.concatenate([
        _pack4(ea, efa, eb, efb), _pack4(eb, ~efb, ea, ~efa)]))

    M, A, FA, B, FB, C = (votes[:, 0], votes[:, 1],
                          votes[:, 2].astype(bool), votes[:, 3],
                          votes[:, 4].astype(bool), votes[:, 5])

    def _is_edge(a, fa, b, fb):
        k = _pack4(a, fa, b, fb)
        p = np.searchsorted(akey, k)
        p = np.minimum(p, max(len(akey) - 1, 0))
        return (len(akey) > 0) & (akey[p] == k)

    zf = np.zeros(len(M), bool)
    row_ok = _is_edge(A, FA, M, zf) & _is_edge(M, zf, B, FB) \
        & (A != M) & (B != M)
    kcnt = np.asarray(ups.kmer_counts)
    row_ok &= kcnt[M] <= cfg.max_repeat_kmers
    # only true junctions qualify: a 1-in/1-out mid is already resolved —
    # splitting it would rewire identically and re-qualify forever
    indeg_m = np.zeros(n, np.int64)
    outdeg_m = np.zeros(n, np.int64)
    np.add.at(outdeg_m, ea[~efa], 1)
    np.add.at(indeg_m, eb[~efb], 1)
    np.add.at(indeg_m, ea[efa], 1)       # rc mirror: a-(fa=True) means
    np.add.at(outdeg_m, eb[efb], 1)      # the edge leaves a's rc end
    row_ok &= (indeg_m[M] >= 2) | (outdeg_m[M] >= 2)
    if not row_ok.any():
        return _ret(ups, g, 0, [])
    M, A, FA, B, FB, C = (x[row_ok] for x in (M, A, FA, B, FB, C))

    # competitor maxima per (mid, in) and per (mid, out)
    inkey = (M << 34) | (A << 2) | (FA.astype(np.int64) << 1)
    outkey = (M << 34) | (B << 2) | (FB.astype(np.int64) << 1) | 1
    def _group_top2(key, c):
        order = np.lexsort((-c, key))
        ks, cs = key[order], c[order]
        first = np.searchsorted(ks, ks, side="left")
        top = cs[first]                       # best in group
        # second-best: best where rank-within-group >= 1
        rank = np.arange(len(ks)) - first
        sec = np.zeros(len(ks), np.int64)
        has2 = np.flatnonzero(rank == 1)
        if len(has2):
            sec_vals = cs[has2]
            sec_first = first[has2]
            tmp = np.zeros(len(ks), np.int64)
            tmp[sec_first] = sec_vals
            sec = tmp[first]
        inv = np.empty(len(ks), np.int64)
        inv[order] = np.arange(len(ks))
        return top[inv], sec[inv]
    in_top, in_sec = _group_top2(inkey, C)
    out_top, out_sec = _group_top2(outkey, C)
    # competitor for row = best OTHER row sharing its in (or out) group
    comp_in = np.where(C == in_top, in_sec, in_top)
    comp_out = np.where(C == out_top, out_sec, out_top)
    comp = np.maximum(comp_in, comp_out)
    dom = (C >= cfg.min_thread_support) & (C >= margin * np.maximum(comp, 1)) \
        & (C > comp)

    if not dom.any():
        return _ret(ups, g, 0, [])

    # one split per dominant row; serialize conflicts (same consumed edge
    # twice cannot happen given dominance exclusivity, but same MID with
    # several dominant rows is fine — one copy each)
    Md, Ad, FAd, Bd, FBd = (x[dom] for x in (M, A, FA, B, FB))
    consumed_in = _pack4(Ad, FAd, Md, np.zeros(len(Md), bool))
    consumed_out = _pack4(Md, np.zeros(len(Md), bool), Bd, FBd)
    # drop consumed edges (and their mirrors) from the deduped edge list
    drop = set(consumed_in.tolist()) | set(consumed_out.tolist()) \
        | set(_pack4(Md, np.ones(len(Md), bool), Ad, ~FAd).tolist()) \
        | set(_pack4(Bd, ~FBd, Md, np.ones(len(Md), bool)).tolist())
    ek = _pack4(ea, efa, eb, efb)
    keep = ~np.isin(ek, np.fromiter(drop, np.int64, len(drop)))

    mcov = ups.mean_cov
    mcov_scaled = None if mcov is None else np.array(mcov, np.float32)
    lens = np.diff(ups.offsets)
    n_copies_of = np.bincount(Md, minlength=n)
    new_edges = []
    new_src, new_kcnt, new_mcov = [], [], []
    next_id = n
    # a mid whose edges are ALL consumed (and that no other dominant row
    # references) would survive as an isolated node and be emitted as a
    # spurious duplicate contig by merge_contigs — reuse it for one of its
    # own dominant rows instead of minting a copy
    kept_nodes = set(ea[keep].tolist()) | set(eb[keep].tolist())
    endpoint_nodes = set(Ad.tolist()) | set(Bd.tolist())
    rewires = []
    reused = set()
    for i in range(len(Md)):
        m = int(Md[i])
        if m not in kept_nodes and m not in endpoint_nodes \
                and m not in reused:
            cid = m
            reused.add(m)
            if mcov_scaled is not None:
                mcov_scaled[m] = \
                    float(mcov[m]) / max(n_copies_of[m], 1)
        else:
            cid = next_id
            next_id += 1
            new_src.append(m)
            new_kcnt.append(int(kcnt[m]))
            if mcov is not None:
                new_mcov.append(float(mcov[m]) / max(n_copies_of[m] + 1, 1))
        new_edges.append((int(Ad[i]), bool(FAd[i]), cid, False))
        new_edges.append((cid, False, int(Bd[i]), bool(FBd[i])))
        rewires.append((m, int(Ad[i]), int(FAd[i]),
                        int(Bd[i]), int(FBd[i]), cid))

    ka = list(ea[keep]) + [t[0] for t in new_edges]
    kfa = list(efa[keep]) + [t[1] for t in new_edges]
    kb = list(eb[keep]) + [t[2] for t in new_edges]
    kfb = list(efb[keep]) + [t[3] for t in new_edges]

    src = np.asarray(new_src, np.int64)
    add_total = int(lens[src].sum()) if len(src) else 0
    new_bases = np.empty(len(ups.bases) + add_total, np.uint8)
    new_bases[: len(ups.bases)] = ups.bases
    offsets = np.zeros(n + len(src) + 1, np.int64)
    offsets[: n + 1] = ups.offsets
    at = len(ups.bases)
    for i, sid in enumerate(src):
        L = int(lens[sid])
        new_bases[at : at + L] = \
            ups.bases[ups.offsets[sid] : ups.offsets[sid] + L]
        at += L
        offsets[n + i + 1] = at
    ups2 = Unipaths(
        bases=new_bases, offsets=offsets,
        kmer_counts=np.concatenate([kcnt, np.asarray(new_kcnt, np.int32)]),
        mean_cov=None if mcov is None else np.concatenate(
            [mcov_scaled, np.asarray(new_mcov, np.float32)]))
    g2 = UniGraph(np.asarray(ka, np.int32), np.asarray(kfa, bool),
                  np.asarray(kb, np.int32), np.asarray(kfb, bool))
    return _ret(ups2, g2, len(Md), rewires)


def revise_paths(rp: ReadPaths, rewires: np.ndarray):
    """Iterate-paths-after-edit (ref: SupportedHyperBasevector re-deriving
    ReadPaths after each graph edit, src/paths/long/): every contiguous
    read triple whose (in, mid, out) pairing was consumed by a split
    re-points its mid entry at the split copy, so the NEXT round of
    support-driven edits sees the edited graph's true support instead of
    stale pre-split node ids. Returns (rp', n_entries_revised)."""
    if rewires is None or len(rewires) == 0:
        return rp, 0
    T = len(rp.uid)
    if T < 3:
        return rp, 0
    off = rp.offsets
    entry_read = np.repeat(np.arange(rp.n_reads), np.diff(off))
    i = np.arange(T - 2)
    same = entry_read[i] == entry_read[i + 2]
    contig = (rp.leave[i] + 1 == rp.enter[i + 1]) & \
             (rp.leave[i + 1] + 1 == rp.enter[i + 2])
    idx = i[same & contig]
    if len(idx) == 0:
        return rp, 0
    # normalize exactly as _thread_counts (mid forced forward)
    a, fa = rp.uid[idx], ~rp.fwd[idx]
    m, fm = rp.uid[idx + 1], ~rp.fwd[idx + 1]
    b, fb = rp.uid[idx + 2], ~rp.fwd[idx + 2]
    na = np.where(fm, b, a)
    nfa = np.where(fm, ~fb, fa)
    nb = np.where(fm, a, b)
    nfb = np.where(fm, ~fa, fb)
    rows = np.stack([m.astype(np.int64), na.astype(np.int64),
                     nfa.astype(np.int64), nb.astype(np.int64),
                     nfb.astype(np.int64)], axis=1)
    rw = np.asarray(rewires, np.int64).reshape(-1, 6)
    # 5-column equi-join via a shared unique-row numbering
    allr = np.concatenate([rw[:, :5], rows])
    _, inv = np.unique(allr, axis=0, return_inverse=True)
    cid_of = np.full(int(inv.max()) + 1, -1, np.int64)
    cid_of[inv[: len(rw)]] = rw[:, 5]
    cid = cid_of[inv[len(rw):]]
    hit = cid >= 0
    if not hit.any():
        return rp, 0
    uid = rp.uid.copy()
    uid[idx[hit] + 1] = cid[hit].astype(uid.dtype)
    return dataclasses.replace(rp, uid=uid), int(hit.sum())


def condense_linear_chains(ups: Unipaths, g: UniGraph, rp: ReadPaths,
                           K: int):
    """Merge maximal unambiguous oriented chains into single unipaths and
    REWRITE the read paths onto the merged nodes (ref: HyperBasevector
    zipping between LongProto simplification passes — after pull-aparts the
    graph holds linear runs like [copy -> junction-kmer] that read-triple
    threading cannot see through; condensing them turns a multi-node repeat
    into one mid that thread_repeats can split next round).

    Returns (ups2, g2, rp2, n_nodes_merged).
    """
    n = ups.n
    if n == 0 or len(g.a) == 0:
        return ups, g, rp, 0

    def _pack4(a, fa, b, fb):
        return (np.asarray(a, np.int64) << 33) | \
            (np.asarray(fa, np.int64) << 32) | \
            (np.asarray(b, np.int64) << 1) | np.asarray(fb, np.int64)

    ekey = np.unique(_pack4(g.a, g.fa, g.b, g.fb))
    ea = (ekey >> 33).astype(np.int64)
    efa = ((ekey >> 32) & 1).astype(bool)
    eb = ((ekey >> 1) & ((1 << 31) - 1)).astype(np.int64)
    efb = (ekey & 1).astype(bool)
    # mirror-closed oriented adjacency
    asrc = np.concatenate([ea * 2 + efa, eb * 2 + ~efb])
    adst = np.concatenate([eb * 2 + efb, ea * 2 + ~efa])
    pair = np.unique(asrc << 32 | adst)
    asrc, adst = pair >> 32, pair & 0xFFFFFFFF
    outdeg = np.bincount(asrc, minlength=2 * n)
    indeg = np.bincount(adst, minlength=2 * n)
    # unique successor map: out(u) == {v} and in(v) == {u}
    nxt = np.full(2 * n, -1, np.int64)
    one = (outdeg[asrc] == 1) & (indeg[adst] == 1)
    nxt[asrc[one]] = adst[one]

    def _onode(c, flip):
        return c * 2 + int(flip)

    # walk maximal chains, each underlying node once (rc-symmetric)
    seen = np.zeros(n, bool)
    chains = []              # list of lists of (node, flip)
    node_chain = np.full(n, -1, np.int64)
    node_posk = np.zeros(n, np.int64)   # chain kmer-offset of node start
    node_flip = np.zeros(n, bool)
    kcnt = np.asarray(ups.kmer_counts).astype(np.int64)
    prv = np.full(2 * n, -1, np.int64)
    src_ok = nxt >= 0
    prv[nxt[src_ok]] = np.flatnonzero(src_ok)
    for c in range(n):
        if seen[c]:
            continue
        u = _onode(c, False)
        visited = {c}
        while prv[u] >= 0 and (prv[u] >> 1) not in visited:
            u = prv[u]
            visited.add(int(u) >> 1)
        chain = []
        koff = 0
        while True:
            node, flip = int(u) >> 1, bool(u & 1)
            if seen[node]:
                break
            chain.append((node, flip))
            seen[node] = True
            node_chain[node] = len(chains)
            node_flip[node] = flip
            node_posk[node] = koff
            koff += kcnt[node]
            v = nxt[u]
            if v < 0 or seen[int(v) >> 1]:
                break
            u = v
        chains.append(chain)
    n_merged = sum(len(ch) - 1 for ch in chains if len(ch) > 1)
    if n_merged == 0:
        return ups, g, rp, 0

    # merged sequences (K-1 collapse) + aggregated stats
    lens = np.diff(ups.offsets)
    mcov = ups.mean_cov
    seqs, new_kcnt, new_mcov = [], [], []
    for ch in chains:
        parts = []
        tot_k = 0
        cov_acc = 0.0
        for j, (node, flip) in enumerate(ch):
            s = ups.sequence(node)
            if flip:
                s = (3 - s[::-1].astype(np.int32)) % 4
                s = s.astype(np.uint8)
            parts.append(s if j == 0 else s[K - 1:])
            tot_k += int(kcnt[node])
            if mcov is not None:
                cov_acc += float(mcov[node]) * int(kcnt[node])
        seqs.append(np.concatenate(parts))
        new_kcnt.append(tot_k)
        if mcov is not None:
            new_mcov.append(cov_acc / max(tot_k, 1))
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    ups2 = Unipaths(
        bases=np.concatenate(seqs) if seqs else np.zeros(0, np.uint8),
        offsets=offsets,
        kmer_counts=np.asarray(new_kcnt, np.int32),
        mean_cov=None if mcov is None else np.asarray(new_mcov, np.float32))

    # surviving edges: everything that is not an interior chain edge
    interior = (nxt[ea * 2 + efa] == eb * 2 + efb)
    ka, kfa, kb, kfb = [], [], [], []
    for a_, fa_, b_, fb_ in zip(ea[~interior], efa[~interior],
                                eb[~interior], efb[~interior]):
        ca, cb = node_chain[a_], node_chain[b_]
        nfa_ = bool(fa_) ^ bool(node_flip[a_])
        nfb_ = bool(fb_) ^ bool(node_flip[b_])
        ka.append(int(ca)); kfa.append(nfa_)
        kb.append(int(cb)); kfb.append(nfb_)
    g2 = UniGraph(np.asarray(ka, np.int32), np.asarray(kfa, bool),
                  np.asarray(kb, np.int32), np.asarray(kfb, bool))

    # rewrite read paths: remap entries, then merge contiguous runs that
    # landed on the same merged node
    uid = rp.uid.astype(np.int64)
    flip_of = node_flip[uid]
    new_uid = node_chain[uid]
    new_fwd = rp.fwd ^ flip_of
    nk = kcnt[uid]
    new_pos = np.where(flip_of,
                       node_posk[uid] + (nk - 1 - rp.pos),
                       node_posk[uid] + rp.pos).astype(np.int32)
    entry_read = np.repeat(np.arange(rp.n_reads), np.diff(rp.offsets))
    T = len(uid)
    if T:
        same_prev = np.zeros(T, bool)
        same_prev[1:] = ((entry_read[1:] == entry_read[:-1])
                         & (new_uid[1:] == new_uid[:-1])
                         & (new_fwd[1:] == new_fwd[:-1])
                         & (rp.enter[1:] == rp.leave[:-1] + 1))
        keep = ~same_prev
        grp = np.cumsum(keep) - 1
        n_out = int(keep.sum())
        out_uid = new_uid[keep].astype(rp.uid.dtype)
        out_fwd = new_fwd[keep]
        out_enter = rp.enter[keep]
        out_leave = np.zeros(n_out, rp.leave.dtype)
        np.maximum.at(out_leave, grp, rp.leave)
        # pos at the (min-enter) first member of each run
        out_pos = new_pos[keep]
        out_reads = entry_read[keep]
        out_off = np.zeros(rp.n_reads + 1, np.int64)
        np.add.at(out_off[1:], out_reads, 1)
        np.cumsum(out_off, out=out_off)
        rp2 = dataclasses.replace(rp, offsets=out_off, uid=out_uid,
                                  fwd=out_fwd, enter=out_enter,
                                  leave=out_leave, pos=out_pos)
    else:
        rp2 = rp
    return ups2, g2, rp2, n_merged


def localize_resolve(ups: Unipaths, g: UniGraph, rp: ReadPaths,
                     cfg: LocalizeConfig = LocalizeConfig()):
    """Full localization pass: edge-support filter, then iterated
    read-thread junction splitting with path revision after every round
    (each split re-points the affected read paths at the new copies, so
    later rounds resolve junctions the stale paths could not).
    Returns (ups', g', metrics, rp') — rp' is the revised read paths,
    consistent with the returned graph's node ids."""
    support = edge_support(g, rp)
    g, n_dropped = filter_unsupported_edges(g, support, cfg)
    total_split = 0
    total_revised = 0
    for _ in range(cfg.max_rounds):
        ups, g, n_split, rw = thread_repeats(ups, g, rp, cfg,
                                             return_rewires=True)
        total_split += n_split
        if n_split == 0:
            break
        rp, n_rev = revise_paths(rp, rw)
        total_revised += n_rev
    return ups, g, {"n_edges_dropped": n_dropped,
                    "n_repeats_split": total_split,
                    "n_path_entries_revised": total_revised}, rp

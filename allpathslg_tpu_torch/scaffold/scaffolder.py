"""Greedy scaffolder + gap remodeling.

Behavior contract (ref: src/paths/MakeScaffolds*.cc — SURVEY.md §2.5 row 17,
§3.5): iterate over contig links in support order, accept the best-supported
consistent link joining free contig ends, grow scaffolds as chains, and
break/skip on conflicts. RemodelGaps (ref: src/paths/RemodelGaps.cc, row 18)
then re-estimates each junction's gap from its spanning pairs against the
library insert distribution (inverse-variance weighting here; full
IntDistribution MLE when empirical distributions land).

The link graph is tiny (thousands of contigs) → host code, like the
reference's own in-memory digraphE<sepdev> walk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from allpathslg_tpu_torch.scaffold.links import LinkGraph
from allpathslg_tpu_torch.scaffold.superb import Superb


@dataclasses.dataclass(frozen=True)
class ScaffoldConfig:
    min_links: int = 2          # pairs required to accept a join
    max_gap_sd: float = 1e9     # reject sloppier link estimates
    # Systematic (non-statistical) layout slop for conflict tests, in bp:
    # absorbs negative-gap clamping, alignlet anchor quantization and
    # contig-end trimming biases that no per-link variance models. The
    # STATISTICAL part of every conflict tolerance is derived from the
    # link SEM + the crossed junctions' gap deviations (see find_conflicts).
    conflict_slop_bp: float = 100.0


class _UF:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def make_scaffolds(lg: LinkGraph, n_contigs: int,
                   cfg: ScaffoldConfig = ScaffoldConfig()) -> List[Superb]:
    """Greedy end-joining. Ends: (contig, 0=start, 1=end)."""
    # edge endpoint ends: oriented-a followed by oriented-b joins
    #   a's trailing end (start if flipped else end) to
    #   b's leading end (end if flipped else start)
    order = np.lexsort((lg.gap_sd, -lg.n_pairs))
    used_end: Dict[Tuple[int, int], Tuple[int, int, float, float, int]] = {}
    uf = _UF(n_contigs)
    for ei in order:
        n = int(lg.n_pairs[ei])
        if n < cfg.min_links or lg.gap_sd[ei] > cfg.max_gap_sd:
            continue
        a, b = int(lg.a[ei]), int(lg.b[ei])
        oa, ob = bool(lg.oa[ei]), bool(lg.ob[ei])
        end_a = (a, 0 if oa else 1)
        end_b = (b, 1 if ob else 0)
        if end_a in used_end or end_b in used_end:
            continue
        if uf.find(a) == uf.find(b):
            continue  # would close a cycle / conflict
        g = float(lg.gap_mean[ei])
        sd = float(lg.gap_sd[ei])
        used_end[end_a] = (*end_b, g, sd, n)
        used_end[end_b] = (*end_a, g, sd, n)
        uf.union(a, b)

    # extract chains
    seen = [False] * n_contigs
    scaffolds: List[Superb] = []
    for c in range(n_contigs):
        if seen[c]:
            continue
        free = [e for e in (0, 1) if (c, e) not in used_end]
        if len(free) == 0:
            continue  # interior contig; reached from a terminus
        # walk from the terminus: the free end faces outward/left
        start_enter_end = free[0]  # entering "via" this end
        chain = []
        cur, enter = c, start_enter_end
        prev_gap = None
        while True:
            seen[cur] = True
            flip = enter == 1
            chain.append((cur, flip, prev_gap))
            exit_end = 1 - enter
            nxt = used_end.get((cur, exit_end))
            if nxt is None:
                break
            ncon, nend, g, sd, n = nxt
            prev_gap = (g, sd, n)
            cur, enter = ncon, nend
            if seen[cur]:
                break
        sb = Superb(
            contig_ids=[x[0] for x in chain],
            rc=[x[1] for x in chain],
            gaps=[int(round(x[2][0])) for x in chain[1:]],
            gap_devs=[int(round(x[2][1])) + 1 for x in chain[1:]],
        )
        scaffolds.append(sb)
    # singletons with both ends used were skipped above only if interior;
    # isolated contigs (no links) have both ends free → emitted already
    for c in range(n_contigs):
        if not seen[c]:
            # cycle component: break arbitrarily at c
            chain = []
            cur, enter = c, 0
            prev_gap = None
            while not seen[cur]:
                seen[cur] = True
                flip = enter == 1
                chain.append((cur, flip, prev_gap))
                nxt = used_end.get((cur, 1 - enter))
                if nxt is None:
                    break
                ncon, nend, g, sd, n = nxt
                prev_gap = (g, sd, n)
                cur, enter = ncon, nend
            scaffolds.append(Superb(
                contig_ids=[x[0] for x in chain],
                rc=[x[1] for x in chain],
                gaps=[int(round(x[2][0])) for x in chain[1:]],
                gap_devs=[int(round(x[2][1])) + 1 for x in chain[1:]],
            ))
    return scaffolds


def _filter_links(lg: LinkGraph, banned) -> LinkGraph:
    if not banned:
        return lg
    keep = np.ones(lg.n_edges, bool)
    keep[list(banned)] = False
    so, sv = None, None
    if lg.span_off is not None:
        lens = np.diff(lg.span_off)[keep]
        so = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=so[1:])
        sv = np.concatenate([lg.spans(i) for i in np.nonzero(keep)[0]]) \
            if keep.any() else np.zeros(0, np.int64)
    return LinkGraph(lg.a[keep], lg.b[keep], lg.oa[keep], lg.ob[keep],
                     lg.n_pairs[keep], lg.gap_mean[keep], lg.gap_sd[keep],
                     so, sv)


def _scaffold_positions(sb: Superb, clens: np.ndarray):
    """Per contig of a scaffold: (start, flip) in scaffold coordinates."""
    pos = {}
    at = 0
    for j, (c, f) in enumerate(zip(sb.contig_ids, sb.rc)):
        pos[c] = (at, bool(f), j)
        at += int(clens[c])
        if j < len(sb.gaps):
            at += int(sb.gaps[j])
    return pos


def find_conflicts(scaffolds: List[Superb], lg: LinkGraph,
                   clens: np.ndarray, cfg: ScaffoldConfig,
                   slack: float = 6.0) -> List[Tuple[int, int]]:
    """Junctions contradicted by the link evidence spanning them (ref: the
    conflict-breaking iteration of src/paths/MakeScaffolds*.cc).

    Every link whose two contigs land in the same scaffold votes FOR the
    junctions between them when its orientation+gap agree with the layout,
    AGAINST when they disagree. Returns [(scaffold_idx, junction_idx)]
    where against-votes outweigh for-votes."""
    clens = np.asarray(clens).astype(np.int64)
    # contig -> scaffold index
    where = {}
    for si, sb in enumerate(scaffolds):
        for c in sb.contig_ids:
            where[c] = si
    pos_cache = [_scaffold_positions(sb, clens) for sb in scaffolds]
    votes: Dict[Tuple[int, int], float] = {}
    for i in range(lg.n_edges):
        a, b = int(lg.a[i]), int(lg.b[i])
        if int(lg.n_pairs[i]) < cfg.min_links:
            continue
        sa, sb_ = where.get(a), where.get(b)
        if sa is None or sa != sb_:
            continue
        pc = pos_cache[sa]
        (pa, fa, ja) = pc[a]
        (pb, fb, jb) = pc[b]
        if ja == jb:
            continue
        mean = float(lg.gap_mean[i])
        sem = float(lg.gap_sd[i])   # links.py stores sd/sqrt(n) — the SEM
        n = int(lg.n_pairs[i])
        # Tolerance on |pred - mean|: mean carries the link SEM; pred
        # carries the layout uncertainty of every junction gap crossed
        # between the two contigs (independent estimates → variances add).
        # conflict_slop_bp absorbs the systematic biases (see ScaffoldConfig).
        lo, hi = min(ja, jb), max(ja, jb)
        layout_var = sum(
            float(scaffolds[sa].gap_devs[j]) ** 2 for j in range(lo, hi))
        tol = slack * np.sqrt(max(sem, 1.0) ** 2 + layout_var) \
            + cfg.conflict_slop_bp
        # two readings of the link: a'(oa) then b'(ob), or rc-mirror
        consistent = False
        if jb > ja and fa == bool(lg.oa[i]) and fb == bool(lg.ob[i]):
            pred = pb - (pa + clens[a])
            consistent = abs(pred - mean) <= tol
        elif ja > jb and fb == (not bool(lg.ob[i])) and fa == (not bool(lg.oa[i])):
            pred = pa - (pb + clens[b])
            consistent = abs(pred - mean) <= tol
        w = float(n) * (1.0 if consistent else -1.0)
        for j in range(lo, hi):
            votes[(sa, j)] = votes.get((sa, j), 0.0) + w

    # insertion conflicts: an OUTSIDE contig x whose supported links imply
    # placements inside a scaffold that disagree with each other or need
    # room a junction's gap cannot provide — evidence a contig is missing
    # at that junction (the greedy accepted a chimeric longer-range link)
    placements: Dict[Tuple[int, int], list] = {}
    for i in range(lg.n_edges):
        n = int(lg.n_pairs[i])
        if n < cfg.min_links:
            continue
        a, b = int(lg.a[i]), int(lg.b[i])
        g = float(lg.gap_mean[i])
        g_sem = float(lg.gap_sd[i])
        for c, x in ((a, b), (b, a)):
            si = where.get(c)
            if si is None or where.get(x) == si:
                continue
            p, f, _ = pos_cache[si][c]
            if c == a:
                if f == bool(lg.oa[i]):
                    start = p + clens[a] + g
                else:
                    start = p - g - clens[b]
            else:
                if f == bool(lg.ob[i]):
                    start = p - g - clens[a]
                else:
                    start = p + clens[b] + g
            placements.setdefault((si, x), []).append(
                (float(start), float(n), g_sem))
    # junction coordinate spans per scaffold
    for (si, x), pls in placements.items():
        if len(pls) < 1:
            continue
        sb = scaffolds[si]
        pc = pos_cache[si]
        lx = float(clens[x])
        # pairwise disagreement between supported placements
        for ai in range(len(pls)):
            for bi in range(ai + 1, len(pls)):
                (s1, w1, e1), (s2, w2, e2) = pls[ai], pls[bi]
                # each placement start carries its link's SEM; slop per
                # ScaffoldConfig.conflict_slop_bp
                tol = slack * np.sqrt(max(e1, 1.0) ** 2
                                      + max(e2, 1.0) ** 2) \
                    + cfg.conflict_slop_bp
                if abs(s1 - s2) <= lx * 0.5 + tol:
                    continue
                lo_c, hi_c = min(s1, s2), max(s1, s2) + lx
                w = w1 + w2
                # vote against every junction inside [lo_c, hi_c]; widen
                # the interval by the fixed slop only — the SEM-derived
                # tol belongs to the disagreement test above, and reusing
                # it here would down-vote junctions far outside the actual
                # disagreement span for sloppy (high-SEM) links
                widen = float(cfg.conflict_slop_bp)
                at = 0.0
                for j in range(len(sb.gaps)):
                    at += float(clens[sb.contig_ids[j]])
                    if lo_c - widen < at < hi_c + widen:
                        votes[(si, j)] = votes.get((si, j), 0.0) - w
                    at += float(sb.gaps[j])
    return [k for k, v in votes.items() if v < 0]


def _break_junctions(scaffolds: List[Superb],
                     breaks: List[Tuple[int, int]]) -> List[Superb]:
    by_s: Dict[int, set] = {}
    for si, j in breaks:
        by_s.setdefault(si, set()).add(j)
    out = []
    for si, sb in enumerate(scaffolds):
        cuts = sorted(by_s.get(si, ()))
        if not cuts:
            out.append(sb)
            continue
        start = 0
        for j in cuts + [len(sb.gaps)]:
            ids = sb.contig_ids[start : j + 1]
            rc = sb.rc[start : j + 1]
            gaps = sb.gaps[start:j]
            devs = sb.gap_devs[start:j]
            if ids:
                out.append(Superb(list(ids), list(rc), list(gaps), list(devs)))
            start = j + 1
    return out


def make_scaffolds_iterative(lg: LinkGraph, n_contigs: int,
                             clens: np.ndarray,
                             cfg: ScaffoldConfig = ScaffoldConfig(),
                             rounds: int = 3):
    """Greedy join + conflict break + retry (ref: MakeScaffolds' iterate-
    accept/re-derive/break loop). Returns (scaffolds, n_broken_total)."""
    banned: set = set()
    n_broken = 0
    scaffolds = make_scaffolds(lg, n_contigs, cfg)
    for _ in range(rounds):
        breaks = find_conflicts(scaffolds, lg, clens, cfg)
        if not breaks:
            break
        n_broken += len(breaks)
        # ban the links that formed the contradicted junctions so the
        # rebuild cannot re-accept them
        emap = {}
        for i in range(lg.n_edges):
            emap[(int(lg.a[i]), int(lg.b[i]), bool(lg.oa[i]),
                  bool(lg.ob[i]))] = i
        for si, j in breaks:
            sb = scaffolds[si]
            c1, f1 = sb.contig_ids[j], sb.rc[j]
            c2, f2 = sb.contig_ids[j + 1], sb.rc[j + 1]
            key = (c1, c2, f1, f2) if c1 <= c2 else (c2, c1, not f2, not f1)
            if key in emap:
                banned.add(emap[key])
        scaffolds = make_scaffolds(_filter_links(lg, banned), n_contigs, cfg)
        # edge ids shifted by filtering; remap by rebuilding each round
        lg_cur = _filter_links(lg, banned)
        # conflicts next round are found against the filtered graph
        lg = lg_cur
        banned = set()
    return scaffolds, n_broken


def remodel_gaps(scaffolds: List[Superb], lg: LinkGraph,
                 dist=None) -> List[Superb]:
    """Re-estimate junction gaps from their spanning pairs (ref:
    src/paths/RemodelGaps.cc). With an empirical per-library insert
    IntDistribution, each junction's gap is the maximum-likelihood value of
    sum_i log pmf_{lib(i)}(d_i + g) over its raw spans; without one (or
    without raw spans) it falls back to the inverse-variance mean.

    `dist` is one IntDistribution (single library) or a list indexed by
    library id (multi-library: each span scored against its own library's
    distribution, ref: per-lib .distribs in SamplePairedReadDistributions)."""
    dists = dist if isinstance(dist, (list, tuple)) else (
        None if dist is None else [dist])
    # index edges by canonical (a, b, oa, ob)
    emap = {}
    for i in range(lg.n_edges):
        emap[(int(lg.a[i]), int(lg.b[i]), bool(lg.oa[i]), bool(lg.ob[i]))] = i

    for sb in scaffolds:
        for j in range(len(sb.gaps)):
            c1, f1 = sb.contig_ids[j], sb.rc[j]
            c2, f2 = sb.contig_ids[j + 1], sb.rc[j + 1]
            # canonical edge form
            if c1 <= c2:
                key = (c1, c2, f1, f2)
            else:
                key = (c2, c1, not f2, not f1)
            i = emap.get(key)
            if i is None:
                continue
            g = float(lg.gap_mean[i])
            sem = float(lg.gap_sd[i])
            n = int(lg.n_pairs[i])
            spans = lg.spans(i)
            if dists is not None and len(spans) >= 2:
                sample_sd = max(sem * np.sqrt(max(n, 1)), 1.0)
                lo = int(g - 4 * sample_sd - 20)
                hi = int(g + 4 * sample_sd + 20)
                libs = lg.span_libs(i)
                if len(libs) != len(spans):
                    libs = np.zeros(len(spans), np.int32)
                # sum per-library log-likelihood grids over the same gap
                # range; a lib id without a distribution contributes nothing
                ll_total = None
                g_mle = g
                for li in np.unique(libs):
                    d = dists[li] if li < len(dists) else None
                    if d is None:
                        continue
                    gs_mle, llg = d.mle_grid(spans[libs == li], lo, hi)
                    if llg is None:
                        continue
                    ll_total = llg if ll_total is None else ll_total + llg
                if ll_total is not None and np.isfinite(ll_total).any():
                    g_mle = lo + int(np.argmax(ll_total))
                    g = float(g_mle)
                    # Fisher-information-style dev: the MLE's curvature is
                    # unavailable cheaply; keep the SEM, floored
                    sem = max(sem, 1.0)
            sb.gaps[j] = int(round(g))
            sb.gap_devs[j] = max(1, int(round(sem)))
    return scaffolds

"""Unipath-graph simplification: bubble popping, spur trimming, linear
merging — the diploid/cleanup engine.

Behavior contract (ref: HyperKmerPath/HyperBasevector cleanup used by
MergeNeighborhoods2 and friends — SURVEY.md §2.4/§2.5 row 14: "zipper
identical prefixes, pop bubbles, remove low-coverage/dead edges", plus the
ploidy=2 contract that het variation collapses into EFASTA {a,b}
ambiguities rather than fragmenting contigs).

Operates on the oriented chain graph from graph/unipath.py (host — the
chain graph is thousands of nodes; per-base work stays on device upstream).

A simple bubble: oriented chains x, y with the same single predecessor
(u, fu) and same single successor (v, fv), similar length. Pop keeps the
higher-coverage branch and records the alternative so finalize can emit
{kept,alt}. Spur: a short, low-coverage dead-end chain hanging off a
junction. After edits, maximal linear runs merge into contigs with K-1
overlap collapsing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from allpathslg_tpu_torch.graph.unipath import UniGraph, Unipaths


@dataclasses.dataclass(frozen=True)
class CleanupConfig:
    bubble_len_dev: float = 0.3    # |len(x)-len(y)| tolerance (fraction)
    bubble_max_len: int = 3000
    spur_max_len: int = 400        # in bases beyond the K-1 overlap
    spur_cov_frac: float = 0.3     # spur coverage vs neighbor to trim


@dataclasses.dataclass
class Contigs:
    """Merged contigs with diploid ambiguity segments for EFASTA."""
    seqs: List[np.ndarray]
    # per contig: list of (offset, kept_segment_len, alt_bases)
    ambiguities: List[List[Tuple[int, int, np.ndarray]]]


def _rc(seq: np.ndarray) -> np.ndarray:
    out = (3 - seq[::-1].astype(np.int32)) % 4
    return np.where(seq[::-1] > 3, 4, out).astype(np.uint8)


def _oseq(ups: Unipaths, c: int, flip: bool) -> np.ndarray:
    s = ups.sequence(c)
    return _rc(s) if flip else s


class ChainGraph:
    """Mutable oriented adjacency with rc symmetry maintained."""

    def __init__(self, ups: Unipaths, g: UniGraph):
        self.ups = ups
        self.out: Dict[Tuple[int, bool], Set[Tuple[int, bool]]] = {}
        self.inn: Dict[Tuple[int, bool], Set[Tuple[int, bool]]] = {}
        self.dead: Set[int] = set()
        for i in range(len(g.a)):
            self._add((int(g.a[i]), bool(g.fa[i])), (int(g.b[i]), bool(g.fb[i])))

    def _add(self, u, v):
        self.out.setdefault(u, set()).add(v)
        self.inn.setdefault(v, set()).add(u)

    def outs(self, u):
        return [v for v in self.out.get(u, ()) if v[0] not in self.dead]

    def ins(self, v):
        return [u for u in self.inn.get(v, ()) if u[0] not in self.dead]

    def kill(self, c: int):
        self.dead.add(c)


def pop_bubbles(cg: ChainGraph, cfg: CleanupConfig, ploidy: int = 2):
    """Returns list of (kept chain, kept flip, alt chain, alt flip, u, v)."""
    ups = cg.ups
    lens = ups.lengths()
    cov = ups.mean_cov if ups.mean_cov is not None else np.ones(ups.n)
    popped = []
    n = ups.n
    for c in range(n):
        if c in cg.dead:
            continue
        for f in (False, True):
            u = (c, f)
            outs = cg.outs(u)
            if len(outs) != 2:
                continue
            (x, fx), (y, fy) = outs
            if x == y or x in cg.dead or y in cg.dead:
                continue
            # both branches: single in, single out, converging
            if len(cg.ins((x, fx))) != 1 or len(cg.ins((y, fy))) != 1:
                continue
            ox = cg.outs((x, fx))
            oy = cg.outs((y, fy))
            if len(ox) != 1 or len(oy) != 1 or ox[0] != oy[0]:
                continue
            lx, ly = int(lens[x]), int(lens[y])
            if max(lx, ly) > cfg.bubble_max_len:
                continue
            if abs(lx - ly) > cfg.bubble_len_dev * max(lx, ly):
                continue
            keep, kf, alt, af = (x, fx, y, fy) if cov[x] >= cov[y] else (y, fy, x, fx)
            cg.kill(alt)
            popped.append((keep, kf, alt, af, u, ox[0]))
    return popped


def trim_spurs(cg: ChainGraph, K: int, cfg: CleanupConfig):
    """Remove short dead-end chains hanging off junctions."""
    ups = cg.ups
    lens = ups.lengths()
    cov = ups.mean_cov if ups.mean_cov is not None else np.ones(ups.n)
    n_trim = 0
    for c in range(ups.n):
        if c in cg.dead:
            continue
        for f in (False, True):
            u = (c, f)
            if cg.outs(u):
                continue  # not a dead end in this orientation
            ins = cg.ins(u)
            if len(ins) != 1:
                continue
            (p, pf) = ins[0]
            if len(cg.outs((p, pf))) < 2:
                continue  # not branching; keep
            if int(lens[c]) - (K - 1) > cfg.spur_max_len:
                continue
            if cov[c] > cfg.spur_cov_frac * max(cov[p], 1e-9):
                continue
            cg.kill(c)
            n_trim += 1
            break
    return n_trim


def merge_contigs(cg: ChainGraph, K: int, popped,
                  record_ambiguities: bool = True) -> Contigs:
    """Walk maximal linear runs of live oriented chains; collapse K-1
    overlaps; splice popped-bubble branches back as ambiguity segments."""
    ups = cg.ups
    # bubble lookup: (u -> (keep, alt)) by the kept branch id+orient
    bub_by_keep = {}
    for keep, kf, alt, af, u, v in popped:
        bub_by_keep[(keep, kf)] = (alt, af)
        bub_by_keep[(keep, not kf)] = (alt, not af)

    def uniq_next(u):
        outs = cg.outs(u)
        if len(outs) != 1:
            return None
        v = outs[0]
        if len(cg.ins(v)) != 1:
            return None
        return v

    def uniq_prev(u):
        ins = cg.ins(u)
        if len(ins) != 1:
            return None
        p = ins[0]
        if len(cg.outs(p)) != 1:
            return None
        return p

    seen: Set[int] = set()
    seqs: List[np.ndarray] = []
    ambs: List[List[Tuple[int, int, np.ndarray]]] = []
    for c in range(ups.n):
        if c in cg.dead or c in seen:
            continue
        # walk back to the run head (guard cycles)
        u = (c, False)
        visited = {u[0]}
        while True:
            p = uniq_prev(u)
            if p is None or p[0] in visited:
                break
            u = p
            visited.add(u[0])
        # walk forward, building sequence
        parts = [np.asarray(_oseq(ups, u[0], u[1]))]
        amb: List[Tuple[int, int, np.ndarray]] = []
        seen.add(u[0])
        pos = len(parts[0])
        while True:
            if record_ambiguities and u in bub_by_keep:
                alt, af = bub_by_keep[u]
                kept_seq = _oseq(ups, u[0], u[1])
                alt_seq = _oseq(ups, alt, af)
                koff = pos - len(kept_seq) + (K - 1)
                kmid = len(kept_seq) - 2 * (K - 1)
                amid = alt_seq[K - 1 : len(alt_seq) - (K - 1)]
                if kmid > 0 or len(amid) > 0:
                    amb.append((koff, max(kmid, 0), np.asarray(amid)))
            v = uniq_next(u)
            if v is None or v[0] in seen:
                break
            u = v
            seen.add(u[0])
            s = np.asarray(_oseq(ups, u[0], u[1]))
            parts.append(s[K - 1:])
            pos += len(s) - (K - 1)
        seqs.append(np.concatenate(parts))
        ambs.append(amb)
    return Contigs(seqs=seqs, ambiguities=ambs)


def simplify(ups: Unipaths, g: UniGraph, K: int, ploidy: int = 2,
             cfg: CleanupConfig = CleanupConfig()):
    """Full cleanup: pop bubbles, trim spurs, merge. Returns
    (Contigs, metrics).

    Bubbles are popped at any ploidy: in diploid mode the alt branch is
    recorded as an EFASTA ambiguity; in haploid mode a simple bubble can
    only be a sequencing-error branch (or an exact repeat pair), so the
    weaker branch is deleted outright — keeping both would break the
    chain AND duplicate the interior (ref: HyperBasevector bubble
    popping runs regardless of ploidy; ploidy only gates whether the
    alternative is preserved as {a,b} ambiguity)."""
    cg = ChainGraph(ups, g)
    popped = pop_bubbles(cg, cfg, ploidy)
    n_spurs = trim_spurs(cg, K, cfg)
    contigs = merge_contigs(cg, K, popped if ploidy >= 2 else [],
                            record_ambiguities=ploidy >= 2)
    metrics = {
        "n_bubbles_popped": len(popped),
        "n_spurs_trimmed": n_spurs,
        "n_contigs": len(contigs.seqs),
        "n_ambiguities": sum(len(a) for a in contigs.ambiguities),
    }
    return contigs, metrics

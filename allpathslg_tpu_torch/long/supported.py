"""Supported assembly graph: edges carry read-path support (port of
allpathslg_tpu/long/supported.py; host code, a copy over the port's
UniGraph, Unipaths and ReadPaths).

Behavior contract (ref: src/paths/long/SupportedHyperBasevector.{h,cc} and
src/paths/long/ReadPath.h): the
second-generation representation keeps, alongside the assembly graph, the
multiset of read paths (edge-id sequences) threading it, and drives graph
simplification from that support: low-support edge deletion and pull-aparts
(duplicating a shared middle segment when paired paths disambiguate a
2-in/2-out junction).

Here the graph is the oriented unipath graph (graph/unipath.UniGraph) and
paths are graph/pathsdb.ReadPaths; support ops reuse the globally-batched
threading machinery of asm/localize.py (the reference's per-read walking,
recast as vectorized joins).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from allpathslg_tpu_torch.graph.pathsdb import ReadPaths
from allpathslg_tpu_torch.graph.unipath import UniGraph, Unipaths
from allpathslg_tpu_torch.asm import localize


@dataclasses.dataclass
class SupportedGraph:
    """Unipath graph + per-edge read-path support + per-node path coverage.

    (ref: SupportedHyperBasevector's paths/weights pair)
    """
    ups: Unipaths
    g: UniGraph
    edge_support: np.ndarray   # int32 [E] reads crossing each adjacency edge
    node_cov: np.ndarray       # int32 [n] path entries touching each unipath

    @property
    def n_edges(self) -> int:
        return len(self.g.a)


def build_supported(ups: Unipaths, g: UniGraph, rp: ReadPaths) -> SupportedGraph:
    sup = localize.edge_support(g, rp)
    cov = np.bincount(rp.uid, minlength=ups.n).astype(np.int32)
    return SupportedGraph(ups=ups, g=g, edge_support=sup, node_cov=cov)


def delete_low_support(sg: SupportedGraph, min_support: int = 2
                       ) -> Tuple[SupportedGraph, int]:
    """Drop edges crossed by fewer than min_support read paths, except
    bridges that would disconnect a node (ref: SupportedHyperBasevector::
    DeleteLowCoverage behavior)."""
    cfg = localize.LocalizeConfig(min_edge_support=min_support)
    g2, n_dropped = localize.filter_unsupported_edges(
        sg.g, sg.edge_support, cfg)
    return dataclasses.replace(
        sg, g=g2,
        edge_support=_resupport(sg, g2)), n_dropped


def _resupport(sg: SupportedGraph, g2: UniGraph) -> np.ndarray:
    """Carry edge support over to a filtered edge list."""
    from allpathslg_tpu_torch.graph.pathsdb import pack_edges
    old = {}
    kf = pack_edges(sg.g.a, sg.g.fa, sg.g.b, sg.g.fb)
    kr = pack_edges(sg.g.b, ~sg.g.fb, sg.g.a, ~sg.g.fa)
    for k, s in zip(np.minimum(kf, kr), sg.edge_support):
        old[int(k)] = int(s)
    kf2 = pack_edges(g2.a, g2.fa, g2.b, g2.fb)
    kr2 = pack_edges(g2.b, ~g2.fb, g2.a, ~g2.fa)
    return np.array([old.get(int(k), 0)
                     for k in np.minimum(kf2, kr2)], np.int32)


def pull_apart(sg: SupportedGraph, rp: ReadPaths,
               min_thread_support: int = 2, max_rounds: int = 8,
               margin: float = 3.0
               ) -> Tuple[SupportedGraph, int, ReadPaths]:
    """Pull-apart: replicate a junction unipath per supported (in, out)
    thread pairing (ref: SupportedHyperBasevector::PullApart — the 2-in/
    2-out case; generalized here to k-in/k-out perfect pairings, then to
    PARTIAL pairings: a dominant pairing — margin x better-supported than
    any competitor on its in- or out-edge — splits off even when the rest
    of the junction stays ambiguous).

    After every split round the read paths are REVISED onto the split
    copies (localize.revise_paths — the reference's iterate-paths-after-
    edit), so consecutive rounds thread junctions whose resolution depends
    on earlier splits, and the returned paths/support reflect the edited
    graph. Returns (sg', n_split, rp')."""
    cfg = localize.LocalizeConfig(min_thread_support=min_thread_support,
                                  max_rounds=max_rounds)
    ups, g, n = sg.ups, sg.g, 0
    for _ in range(max_rounds):
        ups, g, k, rw = localize.thread_repeats(ups, g, rp, cfg,
                                                return_rewires=True)
        n += k
        if k == 0:
            break
        rp, _ = localize.revise_paths(rp, rw)
    for _ in range(max_rounds):
        ups, g, k, rw = localize.thread_repeats_partial(
            ups, g, rp, cfg, margin=margin, return_rewires=True)
        n += k
        if k == 0:
            break
        rp, _ = localize.revise_paths(rp, rw)
    sg2 = build_supported(ups, g, rp)
    return sg2, n, rp


def simplify_supported(sg: SupportedGraph, rp: ReadPaths,
                       min_support: int = 2, min_thread_support: int = 2,
                       ploidy: int = 1, max_iters: int = 4,
                       K: int = None
                       ) -> Tuple[SupportedGraph, Dict[str, int], ReadPaths]:
    """The LongProto cleanup loop, ITERATED to a fixpoint (ref: LongProto's
    repeated simplification passes with path revision between edits):
    low-support deletion, path-supported bubble resolution, pull-aparts
    with path revision, then — when K is given — condensation of the
    linear runs the edits exposed (multi-node repeats become single mids
    the NEXT iteration's triple threading can split) — until an iteration
    changes nothing."""
    tot = {"n_edges_dropped": 0, "n_bubbles_resolved": 0,
           "n_pulled_apart": 0, "n_chain_nodes_merged": 0}
    for _ in range(max_iters):
        sg, n_dropped = delete_low_support(sg, min_support)
        sg, n_bub = resolve_bubbles_by_paths(sg, rp, ploidy=ploidy)
        sg, n_split, rp = pull_apart(sg, rp, min_thread_support)
        n_merged = 0
        if K is not None:
            ups2, g2, rp, n_merged = localize.condense_linear_chains(
                sg.ups, sg.g, rp, K)
            if n_merged:
                sg = build_supported(ups2, g2, rp)
        tot["n_edges_dropped"] += int(n_dropped)
        tot["n_bubbles_resolved"] += int(n_bub)
        tot["n_pulled_apart"] += int(n_split)
        tot["n_chain_nodes_merged"] += int(n_merged)
        if n_dropped + n_bub + n_split + n_merged == 0:
            break
    return sg, tot, rp


def resolve_bubbles_by_paths(sg: SupportedGraph, rp: ReadPaths,
                             min_ratio: float = 3.0, ploidy: int = 1
                             ) -> Tuple[SupportedGraph, int]:
    """Path-supported bubble resolution (ref: SupportedHyperBasevector's
    path-weight-driven bubble handling, src/paths/long/): at every
    2-in/2-out simple bubble, compare READ-PATH support of the two branches
    (min of entry/exit edge crossings) and delete a branch only when it is
    dominated >= min_ratio:1 — sequencing-error branches die, balanced
    (haplotype) bubbles survive for the diploid EFASTA machinery.

    For ploidy 1 a dominated branch is deleted outright; for ploidy 2 a
    branch is deleted only if its support is ALSO below 2 (noise floor) —
    genuine het bubbles keep both sides.
    """
    from allpathslg_tpu_torch.graph.cleanup import ChainGraph
    from allpathslg_tpu_torch.graph.pathsdb import pack_edges
    from allpathslg_tpu_torch.graph.unipath import UniGraph
    import dataclasses as _dc

    g = sg.g
    supp = {}
    kf = pack_edges(g.a, g.fa, g.b, g.fb)
    kr = pack_edges(g.b, ~g.fb, g.a, ~g.fa)
    for k, s in zip(np.minimum(kf, kr), sg.edge_support):
        supp[int(k)] = int(s)

    def esup(u, fu, v, fv):
        a = int(pack_edges(np.array([u]), np.array([fu]),
                           np.array([v]), np.array([fv]))[0])
        b = int(pack_edges(np.array([v]), np.array([not fv]),
                           np.array([u]), np.array([not fu]))[0])
        return supp.get(min(a, b), 0)

    cg = ChainGraph(sg.ups, g)
    killed = set()
    n_resolved = 0
    for c in range(sg.ups.n):
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
            if len(cg.ins((x, fx))) != 1 or len(cg.ins((y, fy))) != 1:
                continue
            ox, oy = cg.outs((x, fx)), cg.outs((y, fy))
            if len(ox) != 1 or len(oy) != 1 or ox[0] != oy[0]:
                continue
            w, fw = ox[0]
            sx = min(esup(c, f, x, fx), esup(x, fx, w, fw))
            sy = min(esup(c, f, y, fy), esup(y, fy, w, fw))
            if sx >= sy:
                alt, s_hi, s_lo = y, sx, sy
            else:
                alt, s_hi, s_lo = x, sy, sx
            if s_hi >= min_ratio * max(s_lo, 1):
                if ploidy >= 2 and s_lo >= 2:
                    continue
                cg.kill(alt)
                killed.add(alt)
                n_resolved += 1
    if not killed:
        return sg, 0
    keep_e = np.array([int(a) not in killed and int(b) not in killed
                       for a, b in zip(g.a, g.b)], bool)
    g2 = UniGraph(a=g.a[keep_e], fa=g.fa[keep_e],
                  b=g.b[keep_e], fb=g.fb[keep_e])
    sg2 = _dc.replace(sg, g=g2, edge_support=sg.edge_support[keep_e])
    return sg2, n_resolved

"""EvalByReads: score an assembly graph by re-threading its reads.

Behavior contract (ref: src/paths/long/EvalByReads.{h,cc} — the LongProto
subtree's internal oracle: an assembly is good iff the reads thread
through it without unsupported transitions; SURVEY.md §2.5 LongProto
row). The reference walks each read through the SupportedHyperBasevector
and classifies placements; here the same question is answered with the
framework's batched machinery: reads path through the graph
(graph/pathsdb device joins), each path's unipath-to-unipath transitions
join against the graph's edge set, and every read is classified as

  placed    — >= min_placed_frac of its windows land on unipaths,
  coherent  — placed AND every transition its path takes is a graph edge
              (no junction crossing the graph cannot explain),
  broken    — placed but at least one transition is unsupported (a
              misjoin or missing edge under that read's evidence).

`eval_by_reads` returns per-read flags plus the summary the reference's
log prints (placed/coherent fractions, unsupported-transition count).
The pipeline's evaluate stage reports genome-truth accuracy; this is the
truth-free complement usable on real data.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from allpathslg_tpu_torch.graph.pathsdb import ReadPaths, pack_edges, transitions
from allpathslg_tpu_torch.graph.unipath import UniGraph


def classify_reads(rp: ReadPaths, g: UniGraph, n_windows: np.ndarray,
                   min_placed_frac: float = 0.5
                   ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Classify each read's path against the graph's edge set.

    rp: read paths (window-compressed); n_windows: int [n_reads] windows
    per read (placement denominator). Returns (placed, coherent, summary).
    """
    n_reads = rp.n_reads
    # placed: fraction of windows that landed on some unipath
    win_on = np.diff(rp.offsets)            # path entries per read
    # each entry covers (leave - enter + 1) windows
    covered = np.zeros(n_reads, np.int64)
    ent = rp.enter.astype(np.int64)
    lea = rp.leave.astype(np.int64)
    read_of = np.repeat(np.arange(n_reads), win_on)
    np.add.at(covered, read_of, np.abs(lea - ent) + 1)
    denom = np.maximum(np.asarray(n_windows, np.int64), 1)
    placed = covered >= min_placed_frac * denom

    # supported transitions: rc-canonical edge keys of the graph
    if len(g.a):
        gf = pack_edges(g.a, g.fa, g.b, g.fb)
        gr = pack_edges(g.b, ~g.fb, g.a, ~g.fa)
        gset = np.unique(np.minimum(gf, gr))
    else:
        gset = np.zeros(0, np.int64)

    # per-read CONTIGUOUS transitions (same convention as
    # pathsdb.transitions: flag True = unipath traversed rc; only
    # window-adjacent entries are junction crossings the graph must
    # explain — gapped entries are read-error skips, not evidence)
    off = rp.offsets
    bad = np.zeros(n_reads, bool)
    T = len(rp.uid)
    nxt_same_read = np.ones(T, bool)
    if T:
        nxt_same_read[off[1:][:-1] - 1] = False
        nxt_same_read[-1] = False
    i = np.nonzero(nxt_same_read)[0]
    i = i[rp.leave[i] + 1 == rp.enter[i + 1]]
    a, fa = rp.uid[i], ~rp.fwd[i]
    b, fb = rp.uid[i + 1], ~rp.fwd[i + 1]
    tk = np.minimum(pack_edges(a, fa, b, fb),
                    pack_edges(b, ~fb, a, ~fa))
    pos = np.searchsorted(gset, tk)
    ok = (pos < len(gset))
    safe = np.minimum(pos, max(len(gset) - 1, 0))
    ok &= (gset[safe] == tk) if len(gset) else False
    n_bad_trans = int((~ok).sum())
    bad_read = np.searchsorted(off, i[~ok], side="right") - 1
    bad[np.unique(bad_read)] = True

    coherent = placed & ~bad
    summary = {
        "n_reads": int(n_reads),
        "placed_frac": round(float(placed.mean()), 4) if n_reads else 0.0,
        "coherent_frac": round(float(coherent.mean()), 4) if n_reads else 0.0,
        "n_unsupported_transitions": n_bad_trans,
    }
    return placed, coherent, summary


def eval_by_reads(codes: np.ndarray, ups, g: UniGraph, placement,
                  min_placed_frac: float = 0.5) -> Dict:
    """Thread `codes` through (ups, g) and classify (ref: EvalByReads).

    placement: graph/unipath KmerPlacement of the graph's kmer table.
    """
    from allpathslg_tpu_torch.graph import pathsdb as pdb

    rp = pdb.path_reads(placement, codes)
    lens = (np.asarray(codes) < 4).sum(axis=1)
    n_windows = np.maximum(lens - placement.K + 1, 0)
    _, _, summary = classify_reads(rp, g, n_windows, min_placed_frac)
    return summary

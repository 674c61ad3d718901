"""Circular scaffold detection (plasmids / organelles).

Behavior contract (ref: src/paths/TagCircularScaffolds.cc — SURVEY.md §2.5
row 21): a scaffold is circular when jump pairs link its trailing end back
to its leading end with a consistent wrap gap.
"""

from __future__ import annotations

from typing import List

import numpy as np

from allpathslg_tpu_torch.scaffold.links import LinkGraph
from allpathslg_tpu_torch.scaffold.superb import Superb


def tag_circular(scaffolds: List[Superb], lg: LinkGraph,
                 wrap_counts: np.ndarray = None,
                 min_links: int = 2) -> List[bool]:
    """wrap_counts: per-contig same-contig wrap-pair counts
    (links.wrap_pair_counts) — evidence for single-contig circles."""
    edge = {}
    for i in range(lg.n_edges):
        edge[(int(lg.a[i]), int(lg.b[i]), bool(lg.oa[i]), bool(lg.ob[i]))] = \
            int(lg.n_pairs[i])
    out = []
    for sb in scaffolds:
        if sb.n_contigs == 1:
            c = sb.contig_ids[0]
            circ = (wrap_counts is not None and c < len(wrap_counts)
                    and wrap_counts[c] >= min_links)
            out.append(bool(circ))
            continue
        c1, f1 = sb.contig_ids[-1], sb.rc[-1]   # trailing oriented contig
        c2, f2 = sb.contig_ids[0], sb.rc[0]     # leading oriented contig
        if c1 <= c2:
            key = (c1, c2, f1, f2)
        else:
            key = (c2, c1, not f2, not f1)
        out.append(edge.get(key, 0) >= min_links)
    return out

"""Edge-table directed graphs with component labeling (port of
allpathslg_tpu/graph/digraph.py).

Behavior contract (ref: src/graph/Digraph.{h,cc} `digraph`/`digraphE<E>`):
the substrate of unipath graphs, link graphs and scaffolds. Edges are
(src, dst) arrays; connected components come from iterated min-label
propagation with pointer jumping. The reference runs it as a
`lax.fori_loop`; here it is a Python loop over the same number of
iterations, on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class EdgeGraph:
    """digraphE analog: n vertices, parallel edge arrays + payload index."""
    n: int
    src: np.ndarray    # int32 [E]
    dst: np.ndarray    # int32 [E]

    @property
    def n_edges(self) -> int:
        return len(self.src)

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n)

    def delete_edges(self, mask: np.ndarray) -> "EdgeGraph":
        keep = ~np.asarray(mask)
        return EdgeGraph(self.n, self.src[keep], self.dst[keep])


def _components(src: torch.Tensor, dst: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    n_iter = max(1, int(np.ceil(np.log2(max(labels.shape[0], 2)))) + 1)
    lab = labels
    for _ in range(2 * n_iter):
        # edge relaxation: both endpoints take the min label
        m = torch.minimum(lab[src], lab[dst])
        lab = lab.scatter_reduce(0, src, m, "amin")
        lab = lab.scatter_reduce(0, dst, m, "amin")
        # pointer jumping through the label array
        lab = lab[lab.long()]
    return lab


def connected_components(g: EdgeGraph) -> np.ndarray:
    """Weakly connected component label (min vertex id) per vertex."""
    if g.n == 0:
        return np.zeros(0, np.int32)
    labels = torch.arange(g.n, dtype=torch.int32)
    if g.n_edges == 0:
        return labels.numpy()
    src = torch.from_numpy(np.asarray(g.src, np.int64))
    dst = torch.from_numpy(np.asarray(g.dst, np.int64))
    return _components(src, dst, labels).numpy()


def components_as_lists(g: EdgeGraph) -> List[np.ndarray]:
    lab = connected_components(g)
    order = np.argsort(lab, kind="stable")
    labs = lab[order]
    cuts = np.nonzero(np.diff(labs))[0] + 1
    return np.split(order, cuts)

"""Cross-shard segmented scans for position-sharded arrays (port of
allpathslg_tpu/parallel/ring.py).

Genome-length coordinate arrays (unipath condensation runs, coverage) are
sharded along the position axis, and a segmented scan must flow across
shard boundaries. Only the boundary aggregate crosses shards: each shard
publishes (tail-run sum, has-any-start) through all_gather and adds the
incoming carry to its open head run, so O(n_shards) scalars cross shards
whatever the array's length.
"""

from __future__ import annotations

import torch

from allpathslg_tpu_torch.ops import segmented
from allpathslg_tpu_torch.parallel import mesh as pmesh


def ring_segmented_cumsum(mesh: pmesh.Mesh, values, starts) -> torch.Tensor:
    """Inclusive segmented cumsum of a position-sharded array, equal to
    ops.segmented.segment_cumsum of the whole array.

    values: [T] (global array or the local shards' blocks), sharded over
    the mesh; starts: bool [T] run-start flags. Returns this process's
    rows of the result (all of it in one process), on mesh.home."""
    vals = pmesh.local_blocks(mesh, values)
    sts = pmesh.local_blocks(mesh, starts)
    if mesh.first == 0:             # the first element is an implicit start
        sts[0] = sts[0].clone()
        sts[0][0] = True
    local = [segmented.segment_cumsum(v, st) for v, st in zip(vals, sts)]
    # the trailing run restarts at the last start, so loc[-1] is its sum
    # (the whole shard's sum when the shard has no start)
    tails = [loc[-1] for loc in local]
    has = [st.any().to(torch.int32) for st in sts]
    tail_all = pmesh.all_gather(mesh, tails)               # [n]
    has_all = pmesh.all_gather(mesh, has).tolist()         # [n] host
    out = []
    for s, (loc, st) in enumerate(zip(local, sts)):
        g = mesh.first + s
        # incoming carry: walk left, summing tails up to and including
        # the nearest shard that holds a start (shard 0 always does)
        k = g - 1
        while k > 0 and not has_all[k]:
            k -= 1
        carry = tail_all[max(k, 0):g].sum(dtype=loc.dtype).to(loc.device)
        nz = torch.nonzero(st)
        first_start = int(nz[0]) if len(nz) else loc.shape[0]
        loc[:first_start] += carry          # the open head run
        out.append(loc)
    return pmesh.concat_local(mesh, out)

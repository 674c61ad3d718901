"""Unipath construction (port of allpathslg_tpu/graph/unipath.py): condense
the de Bruijn graph of canonical k-mers into maximal unbranched paths with
sorts, joins and pointer doubling on the device.

Behavior contract (ref: src/paths/Unipath.cc `Unipath()`, Unipather.cc,
KmerBaseBroker): given the kmer set of (corrected) reads, emit unipaths
(maximal runs of kmers with unique extension) and their base sequences
(unibases), with reverse-complement involution handled so each unipath
appears exactly once.

Algorithm, as in the reference:
  * 2M oriented nodes over M canonical kmers (node id = 2*i + orient);
  * successor lookup: shift-append each base, canonicalize, binary-search
    the sorted kmer table -> out-degrees and unique successors;
  * chain edge x->y iff outdeg(x)==1 and indeg(y)==1, indeg(x) =
    outdeg(flip x); prev[x] = flip(next[flip x]);
  * chains by pointer doubling on prev (min-label doubling breaks cycles
    at their minimum-id node, then distance-to-head doubling);
  * nodes sorted by (head, dist) through the port's stable sort
    (ops/sort: the Hopper radix sort on a CUDA device);
  * every output base is one dynamic 2-bit extract.

The reference has a fused and a chunked form of the chain phase with
identical outputs; the port runs one plain-torch form with the same
iteration counts. On a mesh, the per-chain count sums come from the
cross-shard segmented scan (parallel/ring), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from allpathslg_tpu_torch.graph.pathsdb import KmerPlacement
from allpathslg_tpu_torch.kmer import bits
from allpathslg_tpu_torch.ops import join, segmented, sort as ops_sort


@dataclasses.dataclass
class Unipaths:
    """Host-side unipath set (ragged)."""
    bases: np.ndarray      # uint8 [total] concatenated unibase sequences
    offsets: np.ndarray    # int64 [n+1] start offsets into bases
    kmer_counts: np.ndarray  # int32 [n] kmers per unipath (len - K + 1)
    mean_cov: Optional[np.ndarray] = None  # float [n] mean kmer multiplicity

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def sequence(self, i: int) -> np.ndarray:
        return self.bases[self.offsets[i] : self.offsets[i + 1]]


@dataclasses.dataclass
class UniGraph:
    """Oriented unipath adjacency (K-1 overlap semantics at junctions —
    the HyperBasevector structure, ref: src/paths/HyperBasevector.h).
    Edge: oriented chain (a, fa) is followed by oriented chain (b, fb)."""
    a: np.ndarray    # int32 [E]
    fa: np.ndarray   # bool [E]
    b: np.ndarray    # int32 [E]
    fb: np.ndarray   # bool [E]


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _node_values(table, K: int):
    """Oriented node values: [2M] word tensors, node 2i fwd / 2i+1 rc."""
    rc = bits.rc_words(table, K)
    return [torch.stack([wf, wr], dim=1).reshape(-1)
            for wf, wr in zip(table, rc)]


def _succ_probe(table, vals, K: int, b: int):
    """One base's successor probe (shift-append + canonical + join)."""
    s = bits.shift_append(vals, b, K)
    canon, is_rc = bits.canonical(s, K)
    idx, found = join.searchsorted_words(table, canon)
    return idx.long() * 2 + is_rc.long(), found


def _double_min(ptr, lab):
    return ptr[ptr], torch.minimum(lab, lab[ptr])


def _double_dist(ptr, dist):
    return ptr[ptr], dist + dist[ptr]


def _chain_phase(table, K: int):
    """Phase 1: next/prev pointers, chain heads, distances, per-node info.

    table: W sorted unique canonical kmer word tensors [M].
    Returns (head, dist, vals) over 2M oriented nodes."""
    M = int(table[0].shape[0])
    n_nodes = 2 * M
    dev = table[0].device
    vals = _node_values(table, K)
    outdeg = torch.zeros(n_nodes, dtype=torch.int32, device=dev)
    succ = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    for b in range(4):
        node, found = _succ_probe(table, vals, K, b)
        outdeg = outdeg + found.int()
        succ = torch.where(found, node, succ)
    node_ids = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    y = torch.where(outdeg == 1, succ, -1)
    ok = (y >= 0) & (outdeg[y.clamp(min=0) ^ 1] == 1)
    nxt = torch.where(ok, y, -1)
    # rc symmetry gives prev without scatter: prev[x] = flip(next[flip x])
    nf = nxt[node_ids ^ 1]
    prv = torch.where(nf >= 0, nf ^ 1, -1)

    n_iter = max(1, int(np.ceil(np.log2(max(n_nodes, 2)))) + 1)
    # min-label doubling to find cycle representatives
    ptr = torch.where(prv >= 0, prv, node_ids)
    lab = node_ids
    for _ in range(n_iter):
        ptr, lab = _double_min(ptr, lab)
    # path nodes end at a head (prev==-1); cycle nodes never do
    in_cycle = prv[ptr] >= 0
    # break each cycle at its min-label node
    is_head = (prv < 0) | (in_cycle & (lab == node_ids))
    prv = torch.where(is_head, -1, prv)
    # distance-to-head pointer jumping
    ptr = torch.where(prv >= 0, prv, node_ids)
    dist = torch.where(is_head, 0, 1).to(torch.int32)
    for _ in range(n_iter):
        ptr, dist = _double_dist(ptr, dist)
    return ptr, dist, vals   # converged pointer = head


def _order_phase(head, dist):
    """Phase 2: sort nodes by (head, dist); chain bookkeeping + rc dedupe.

    Returns (order, chain_start_flag, chain_len_at_start,
    keep_chain_flag) in sorted order."""
    n_nodes = head.shape[0]
    dev = head.device
    skeys, spay = ops_sort.sort_by_words(
        [head.long(), dist.long()],
        [torch.arange(n_nodes, dtype=torch.int32, device=dev)])
    order = spay[0].long()              # node ids in (head, dist) order
    starts = ops_sort.run_starts([skeys[0]])   # runs of equal head
    rl = segmented.run_lengths(starts)
    idx = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    start_pos = (idx - segmented.position_in_run(starts)).long()
    chain_len = rl.long()[start_pos]    # broadcast chain length
    tail_node = order[start_pos + chain_len - 1]
    head_node = order[start_pos]
    keep = head_node <= (tail_node ^ 1)  # keep one of each rc pair
    return order, starts, rl, keep


def _as_words(words, device) -> list:
    return [w.long().to(device) if torch.is_tensor(w)
            else torch.from_numpy(np.asarray(w).astype(np.int64)).to(device)
            for w in words]


def _chain_sums_ring(mesh, node_counts: np.ndarray,
                     starts_np: np.ndarray) -> np.ndarray:
    """Per-position inclusive within-chain count sums, computed
    position-sharded over the mesh through parallel.ring: padded to a
    shard-divisible length (padding rows are their own 1-element segments,
    so no carry leaks), the cross-shard segmented cumsum, back to the host.

    int32 on the device, as in the reference: the worst-case chain sum is
    guarded so the scan cannot wrap where the host path's int64 cumsum
    would not."""
    from allpathslg_tpu_torch.parallel.ring import ring_segmented_cumsum

    n_sh = mesh.size
    T = len(node_counts)
    Tp = -(-T // n_sh) * n_sh
    total = int(np.asarray(node_counts, np.int64).sum())
    if total >= 2**31:
        raise OverflowError(
            f"chain count sum {total} >= 2^31: int32 ring scan would wrap; "
            "chunk the count stream or raise the EC max_freq cap")
    vals = np.zeros(Tp, np.int32)
    vals[:T] = node_counts
    sts = np.ones(Tp, bool)
    sts[:T] = starts_np
    seg = ring_segmented_cumsum(mesh, vals, sts)
    return _np(seg)[:T]


def build_unipaths(table_words, K: int, min_count: int = 2, counts=None,
                   with_graph: bool = False, with_placement: bool = False,
                   mesh=None, device="cuda"):
    """Host entry point: kmer table (sorted canonical, possibly padded with
    sentinels + counts) -> unipaths with base sequences (and optionally
    the oriented unipath adjacency graph and the kmer placement).

    table_words: W word arrays (tensors, or uint32 numpy); counts: the
    table's counts (tensor or numpy) or None. The work runs on `device`;
    with a `mesh` (parallel/mesh), the chain count sums run on it."""
    tw = _as_words(table_words, device)
    counts_f = None
    if counts is not None:
        counts_np = _np(counts) if torch.is_tensor(counts) \
            else np.asarray(counts)
        mask = counts_np >= min_count
        mask_t = torch.from_numpy(mask).to(device)
        tw = [w[mask_t] for w in tw]
        counts_f = counts_np[mask]
    M = int(tw[0].shape[0])
    if M == 0:
        empty = Unipaths(np.zeros(0, np.uint8), np.zeros(1, np.int64),
                         np.zeros(0, np.int32))
        out = [empty]
        if with_graph:
            z = np.zeros(0)
            out.append(UniGraph(z.astype(np.int32), z.astype(bool),
                                z.astype(np.int32), z.astype(bool)))
        if with_placement:
            out.append(KmerPlacement(
                K=K, table=[w[:0] for w in tw],
                uid=np.zeros(0, np.int32), upos=np.zeros(0, np.int32),
                urc=np.zeros(0, bool)))
        return out[0] if len(out) == 1 else tuple(out)

    head, dist, vals = _chain_phase(tw, K)
    order, starts, rl, keep = _order_phase(head, dist)

    # host: gather kept-chain structure (stage boundary; sizes become static)
    order_np = _np(order).astype(np.int32)
    starts_np = _np(starts)
    rl_np = _np(rl)
    keep_np = _np(keep)

    chain_starts = np.nonzero(starts_np)[0]
    lens = rl_np[chain_starts]
    kept = keep_np[chain_starts]
    chain_starts = chain_starts[kept]
    lens = lens[kept]
    n_chains = len(chain_starts)
    seq_lens = lens + K - 1
    seq_off = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(seq_lens, out=seq_off[1:])
    total = int(seq_off[-1])

    bases = _emit_bases(vals, K, order,
                        torch.from_numpy(chain_starts.astype(np.int64))
                        .to(device),
                        torch.from_numpy(seq_off).to(device), total)

    # per-unipath mean kmer multiplicity (ref: UnipathCoverage input)
    mean_cov = None
    if counts_f is not None:
        node_counts = counts_f[order_np >> 1]  # node -> its canonical kmer
        if mesh is not None and len(node_counts):
            # chain totals through the cross-shard segmented scan over the
            # position-sharded chain-sorted counts; only the O(n_shards)
            # boundary carry crosses shards. Integer-exact, so artifacts
            # equal the 1-device path's.
            seg = _chain_sums_ring(mesh, node_counts, starts_np)
            chain_sums = seg[chain_starts + lens - 1]
        else:
            csum = np.concatenate([[0], np.cumsum(node_counts)])
            chain_sums = csum[chain_starts + lens] - csum[chain_starts]
        mean_cov = (chain_sums / np.maximum(lens, 1)).astype(np.float32)

    ups = Unipaths(bases=_np(bases), offsets=seq_off,
                   kmer_counts=lens.astype(np.int32), mean_cov=mean_cov)

    placement = None
    if with_placement:
        # kmer table row -> (kept chain, offset, orientation). Each
        # canonical kmer sits in exactly one kept chain (rc twins were
        # dropped by `keep`)
        flat_idx = np.repeat(chain_starts, lens) + _ragged_arange(lens)
        nodes = order_np[flat_idx]
        kidx = nodes >> 1
        uid = np.zeros(M, np.int32)
        upos = np.zeros(M, np.int32)
        urc = np.zeros(M, bool)
        uid[kidx] = np.repeat(np.arange(n_chains, dtype=np.int32), lens)
        upos[kidx] = _ragged_arange(lens)
        urc[kidx] = (nodes & 1).astype(bool)
        placement = KmerPlacement(K=K, table=tw, uid=uid, upos=upos, urc=urc)

    if not with_graph:
        return (ups, placement) if with_placement else ups

    # --- oriented chain adjacency (edges via successor joins) ---
    n_nodes = 2 * M
    heads = order_np[chain_starts]                      # kept chain heads
    tails = order_np[chain_starts + lens - 1]
    # leading-node map: node -> (kept chain, orientation entering via it)
    lead_chain = np.full(n_nodes, -1, np.int32)
    lead_orient = np.zeros(n_nodes, bool)
    lead_chain[heads] = np.arange(n_chains, dtype=np.int32)
    lead_orient[heads] = False
    lead_chain[tails ^ 1] = np.arange(n_chains, dtype=np.int32)
    lead_orient[tails ^ 1] = True

    # trailing kmer values of oriented chains: (c,0) trails with tail node,
    # (c,1) trails with head^1
    trail_nodes = torch.from_numpy(
        np.concatenate([tails, heads ^ 1]).astype(np.int64)).to(device)
    tvals = [v[trail_nodes] for v in vals]
    ea_parts, efa_parts, eb_parts, efb_parts = [], [], [], []
    src_ids = np.arange(2 * n_chains, dtype=np.int32) % n_chains
    src_flips = np.arange(2 * n_chains) >= n_chains
    for bb in range(4):
        node_t, found_t = _succ_probe(tw, tvals, K, bb)
        node = _np(node_t).astype(np.int32)
        fnd = _np(found_t)
        tc = np.where(fnd, lead_chain[np.where(fnd, node, 0)], -1)
        m = tc >= 0
        ea_parts.append(src_ids[m])
        efa_parts.append(src_flips[m])
        eb_parts.append(tc[m].astype(np.int32))
        efb_parts.append(lead_orient[node[m]])
    graph = UniGraph(np.concatenate(ea_parts), np.concatenate(efa_parts),
                     np.concatenate(eb_parts), np.concatenate(efb_parts))
    return (ups, graph, placement) if with_placement else (ups, graph)


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    if len(lens) == 0:
        return np.zeros(0, np.int32)
    total = int(lens.sum())
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return (np.arange(total, dtype=np.int64)
            - np.repeat(starts, lens)).astype(np.int32)


def _emit_bases(vals, K: int, order, chain_starts, seq_off, total: int):
    """Every output base via inverse map: position t -> (chain, offset) ->
    (node, base-in-kmer) -> 2-bit extract."""
    t = torch.arange(total, dtype=torch.int64, device=order.device)
    c = torch.searchsorted(seq_off, t, right=True) - 1
    r = t - seq_off[c]
    node_rank = (r - (K - 1)).clamp(min=0)
    node = order[chain_starts[c] + node_rank]
    j = r.clamp(max=K - 1)
    return bits.get_base_dyn([v[node] for v in vals], j)

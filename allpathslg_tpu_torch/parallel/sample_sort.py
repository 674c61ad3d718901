"""Distributed sample sort over a device mesh (port of
allpathslg_tpu/parallel/sample_sort.py).

Sorts multi-word key/payload records across every shard (ref: the OpenMP
`ParallelSort`/`SortSync` workhorse, src/ParallelVecUtilities.h):

  1. local sort per shard (ops/sort.sort_by_words: the Hopper radix sort
     on a CUDA device, stable like the reference's lax.sort);
  2. every shard contributes `oversample` evenly spaced sample keys ->
     all_gather -> sorted -> the global splitters (the same on every
     shard);
  3. each local element's bucket is its rank among the splitters (the
     elements are sorted, so buckets are contiguous runs);
  4. all_to_all into the owner shards with a fixed capacity a bucket;
     elements past it are counted, never silently dropped;
  5. local merge: one more stable local sort of the received records.

Keys are uint32 words (int64 tensors holding them), lexicographic;
payloads ride along. Every sort is stable and equal keys land in one
bucket, so equal keys leave in their global input order. Shard i holds the
i-th contiguous range of the global order, sentinel-padded at its tail.

Under overflow the reference writes every element past capacity to slot 0
(`slot_safe = where(ok, slot, 0)`), colliding with the element at bucket
0, position 0, and which write XLA keeps is unspecified; here only the
elements within capacity are written. Without overflow the two agree
array for array.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from allpathslg_tpu_torch.ops import sort as ops_sort
from allpathslg_tpu_torch.parallel import mesh as pmesh

SENTINEL = 0xFFFFFFFF
AXIS = pmesh.AXIS


def _less(words_at: Sequence[torch.Tensor], q: Sequence[torch.Tensor]):
    """words_at < q lexicographically, elementwise."""
    lt = torch.zeros_like(q[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for w, qq in zip(words_at, q):
        lt = lt | (eq & (w < qq))
        eq = eq & (w == qq)
    return lt


def _searchsorted_words(sorted_words: Sequence[torch.Tensor],
                        query_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rank (side='left') of each query in the sorted multi-word keys: a
    vectorised lexicographic binary search with the reference's iteration
    count. int64 [Q]. Keys of up to 6 words do not pack into one int64,
    so the words are compared one by one."""
    n = sorted_words[0].shape[0]
    lo = torch.zeros(query_words[0].shape, dtype=torch.int64,
                     device=query_words[0].device)
    hi = lo + n
    n_iter = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    for _ in range(n_iter):
        mid = (lo + hi) // 2
        at = mid.clamp(0, n - 1)
        go_right = _less([w[at] for w in sorted_words], query_words) \
            & (mid < n)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _is_sentinel(words: Sequence[torch.Tensor]) -> torch.Tensor:
    m = words[0] == SENTINEL
    for w in words[1:]:
        m = m & (w == SENTINEL)
    return m


def sample_sort_blocks(mesh: pmesh.Mesh, word_blocks, pay_blocks,
                       oversample: int = 32, capacity_factor: float = 2.0):
    """sample_sort over the local shards' blocks: word_blocks[s] /
    pay_blocks[s] are shard s's W key words / payloads. Returns
    (sorted words a shard, sorted payloads a shard, n_real a shard
    (ints), n_dropped over the mesh (int))."""
    n = mesh.size
    per_shard = word_blocks[0][0].shape[0]
    cap = int(np.ceil(per_shard * capacity_factor / 128.0)) * 128
    W = len(word_blocks[0])

    # 1) local sort; 2) samples
    local, samples = [], []
    for ws, ps in zip(word_blocks, pay_blocks):
        ws, ps = ops_sort.sort_by_words(list(ws), list(ps))
        local.append((ws, ps))
        s_idx = (torch.arange(oversample, device=ws[0].device)
                 * per_shard) // oversample
        samples.append(torch.stack([w[s_idx] for w in ws]))   # [W, s]
    gathered = pmesh.all_gather(mesh, samples)                # [n, W, s]
    gathered = gathered.permute(1, 0, 2).reshape(W, -1)
    gsorted, _ = ops_sort.sort_by_words(list(gathered))
    m = gsorted[0].shape[0]
    sp_idx = (torch.arange(1, n, device=gathered.device) * m) // n
    splitters = [g[sp_idx] for g in gsorted]                  # [n - 1]

    # 3) buckets, slots and the fixed-capacity send buffers
    bufs, dropped = [], []
    for ws, ps in local:
        dev = ws[0].device
        idx = torch.arange(per_shard, device=dev)
        if n > 1:
            ranks = _searchsorted_words(ws, [s.to(dev) for s in splitters])
            bucket = torch.searchsorted(ranks, idx, right=True)
            bounds = torch.cat([ranks.new_zeros(1), ranks])
            pos = idx - bounds[bucket]
        else:
            bucket = torch.zeros_like(idx)
            pos = idx
        ok = pos < cap
        dropped.append((~ok).sum())
        slot = (bucket * cap + pos)[ok]
        buf = []
        for i, a in enumerate(list(ws) + list(ps)):
            b = torch.full((n * cap,), SENTINEL if i < W else 0,
                           dtype=a.dtype, device=dev)
            b[slot] = a[ok]
            buf.append(b)
        bufs.append(buf)

    # 4) all_to_all: bucket b of every shard -> shard b
    recv = [pmesh.all_to_all(mesh, [b[i] for b in bufs])
            for i in range(len(bufs[0]))]
    # 5) local merge
    out_w, out_p, n_real = [], [], []
    for s in range(mesh.n_local):
        rw, rp = ops_sort.sort_by_words([recv[i][s] for i in range(W)],
                                        [r[s] for r in recv[W:]])
        out_w.append(rw)
        out_p.append(rp)
        n_real.append(int((~_is_sentinel(rw)).sum()))
    n_drop = int(pmesh.psum(mesh, dropped))
    return out_w, out_p, n_real, n_drop


def sample_sort(mesh: pmesh.Mesh, words: Sequence, payloads: Sequence = (),
                oversample: int = 32, capacity_factor: float = 2.0):
    """Globally sort sharded multi-word keys (+ payloads) across the mesh.

    words / payloads: global arrays (or the local shards' blocks) sharded
    on axis 0; sentinel (all-ones) keys sort last and pad shard tails.

    Returns (sorted_words, sorted_payloads, n_real_per_shard, n_dropped)
    as the reference does: each array is this process's rows of the global
    [size * size * cap] result (all of it in one process) on mesh.home,
    shard i's rows holding global-order range i, sentinel-padded; n_real
    int32 [n_local]; n_dropped the count past capacity over the mesh (0 in
    healthy runs: raise capacity_factor if not)."""
    wb = [pmesh.local_blocks(mesh, w) for w in words]
    pb = [pmesh.local_blocks(mesh, p) for p in payloads]
    out_w, out_p, n_real, n_drop = sample_sort_blocks(
        mesh, [[w[s] for w in wb] for s in range(mesh.n_local)],
        [[p[s] for p in pb] for s in range(mesh.n_local)],
        oversample, capacity_factor)
    sw = [pmesh.concat_local(mesh, [o[i] for o in out_w])
          for i in range(len(words))]
    sp = [pmesh.concat_local(mesh, [o[i] for o in out_p])
          for i in range(len(payloads))]
    return (sw, sp, torch.tensor(n_real, dtype=torch.int32, device=mesh.home),
            n_drop)

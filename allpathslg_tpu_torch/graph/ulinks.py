"""Unipath link graph from read-pair placements (port of
allpathslg_tpu/graph/ulinks.py).

Behavior contract (ref: src/paths/BuildUnipathLinkGraphsLG.cc and
UnipathNhood's sepdev edges — SURVEY.md §2.4/§2.5 row 12): edges between
oriented unipaths carry (separation ± deviation, #pairs), estimated from
read pairs whose two reads place on different unipaths; CN=1 unipaths form
the seed/neighborhood backbone for localization and jump scaffolding.

Placements come from the device pathing join (graph/pathsdb.path_reads,
on the card in the port); link accumulation is a host pack-sort-unique
aggregation whose key sort is the native stable radix sort
(native/radix_sort.cpp, from 2**14 keys; numpy's stable argsort below, as
in the reference). The sort must be stable: sep and dev are float64
`np.add.reduceat` sums over the sorted order, and their float32 values
match the reference's bit for bit only in the same order. Host numpy, a
copy of the reference's. Orientation flags use the UniGraph flip
convention (True = traversed reverse-complemented).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from allpathslg_tpu_torch.graph.pathsdb import ReadPaths
from allpathslg_tpu_torch.native.build import sort_u64_with_payload


@dataclasses.dataclass
class UlinkGraph:
    """Oriented unipath links: (a, fla) precedes (b, flb) at sep ± dev."""
    a: np.ndarray         # int32 [E]
    fla: np.ndarray       # bool [E]
    b: np.ndarray         # int32 [E]
    flb: np.ndarray       # bool [E]
    n_pairs: np.ndarray   # int32 [E]
    sep: np.ndarray       # float32 [E] mean separation (kmer units ~ bases)
    dev: np.ndarray       # float32 [E] standard deviation of separation

    @property
    def n_edges(self) -> int:
        return len(self.a)


def first_placements(rp: ReadPaths) -> Tuple[np.ndarray, ...]:
    """Per read: (has_placement, uid, fwd, enter, pos) of its first entry."""
    n = rp.n_reads
    cnt = np.diff(rp.offsets)
    has = cnt > 0
    first = rp.offsets[:-1].astype(np.int64)
    safe = np.where(has, first, 0)
    return (has, np.where(has, rp.uid[safe], -1),
            rp.fwd[safe] & has, rp.enter[safe], rp.pos[safe])


def build_ulink_graph(rp: ReadPaths, pairs: np.ndarray,
                      uni_kmers: np.ndarray, K: int,
                      insert_mean: float, insert_sd: float,
                      cn: Optional[np.ndarray] = None,
                      min_pairs: int = 2) -> UlinkGraph:
    """Accumulate oriented unipath links from innie pairs.

    pairs: int32 [P, 2] read indices (r1 molecule-fwd, r2 molecule-rc).
    uni_kmers: kmer count per unipath. cn: optional copy numbers — links
    restricted to CN=1 unipaths when given (the reference links only
    CN=1 "normal" unipaths).
    """
    has, uid, fwd, enter, pos = first_placements(rp)
    r1, r2 = pairs[:, 0], pairs[:, 1]
    ok = has[r1] & has[r2]
    u1, u2 = uid[r1], uid[r2]
    ok &= (u1 != u2) & (u1 >= 0) & (u2 >= 0)
    if cn is not None:
        cnsafe = np.asarray(cn)
        ok &= (cnsafe[np.maximum(u1, 0)] == 1) & (cnsafe[np.maximum(u2, 0)] == 1)
    idx = np.nonzero(ok)[0]
    if len(idx) == 0:
        z = np.zeros(0)
        return UlinkGraph(z.astype(np.int32), z.astype(bool),
                          z.astype(np.int32), z.astype(bool),
                          z.astype(np.int32), z.astype(np.float32),
                          z.astype(np.float32))

    r1, r2, u1, u2 = r1[idx], r2[idx], u1[idx], u2[idx]
    uk1 = uni_kmers[u1].astype(np.int64)
    uk2 = uni_kmers[u2].astype(np.int64)
    ikm = int(round(insert_mean)) - K  # last kmer start on the molecule

    # molecule coords (kmer units) of the oriented unipaths
    o1 = np.where(fwd[r1], pos[r1], uk1 - 1 - pos[r1])
    sA = enter[r1] - o1
    flA = ~fwd[r1]

    o2 = np.where(fwd[r2], pos[r2], uk2 - 1 - pos[r2])
    sB = ikm - enter[r2] - (uk2 - 1 - o2)
    flB = fwd[r2]

    sep = sB - (sA + uk1)

    # orient each link so it reads A→B along the molecule; canonicalize rc:
    # (a,fa)->(b,fb) ≡ (b,!fb)->(a,!fa)
    key_f = _pack(u1, flA, u2, flB)
    key_r = _pack(u2, ~flB, u1, ~flA)
    use_r = key_r < key_f
    key = np.where(use_r, key_r, key_f)

    key_s, order = sort_u64_with_payload(
        key.astype(np.uint64), np.arange(len(key), dtype=np.int64))
    key_s = key_s.astype(np.int64)
    sep_s = sep[order].astype(np.float64)
    uniq, start, counts = np.unique(key_s, return_index=True,
                                    return_counts=True)
    sums = np.add.reduceat(sep_s, start)
    sqs = np.add.reduceat(sep_s * sep_s, start)
    mean = sums / counts
    var = np.maximum(sqs / counts - mean * mean, 0.0)
    dev = np.sqrt(var + float(insert_sd) ** 2 / np.maximum(counts, 1))

    keep = counts >= min_pairs
    a, fla, b, flb = _unpack(uniq[keep])
    return UlinkGraph(a=a, fla=fla, b=b, flb=flb,
                      n_pairs=counts[keep].astype(np.int32),
                      sep=mean[keep].astype(np.float32),
                      dev=dev[keep].astype(np.float32))


def neighborhoods(lg: UlinkGraph, seeds: np.ndarray, max_sep: float,
                  max_size: int = 64):
    """Per-seed BFS over the link graph within max_sep total separation —
    the reference's per-seed neighborhood recruitment (ref:
    LocalizeReadsLG seed/nhood construction, SURVEY.md §3.4). Returns a
    list of (member unipath ids) per seed."""
    from collections import defaultdict, deque
    adj = defaultdict(list)
    for i in range(lg.n_edges):
        adj[int(lg.a[i])].append((int(lg.b[i]), float(lg.sep[i])))
        adj[int(lg.b[i])].append((int(lg.a[i]), float(lg.sep[i])))
    out = []
    for s in seeds:
        seen = {int(s): 0.0}
        q = deque([(int(s), 0.0)])
        while q and len(seen) < max_size:
            u, d = q.popleft()
            for v, sep in adj[u]:
                nd = d + max(sep, 0.0) + 1.0
                if nd <= max_sep and v not in seen:
                    seen[v] = nd
                    q.append((v, nd))
        out.append(np.asarray(sorted(seen), np.int32))
    return out


def _pack(a, fa, b, fb):
    return ((a.astype(np.int64) << 33) | (fa.astype(np.int64) << 32)
            | (b.astype(np.int64) << 1) | fb.astype(np.int64))


def _unpack(key):
    a = (key >> 33).astype(np.int32)
    fa = ((key >> 32) & 1).astype(bool)
    b = ((key >> 1) & ((1 << 31) - 1)).astype(np.int32)
    fb = (key & 1).astype(bool)
    return a, fa, b, fb

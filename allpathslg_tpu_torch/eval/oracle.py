"""Independent numpy/python oracles for device kernels (port of
allpathslg_tpu/eval/oracle.py).

Deliberately simple host oracles (dict/set based) that the tests and the
pipeline's check_mode and evaluation="CHEAT" diagnostics compare against.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Set

import numpy as np


def rc_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def kmer_tuple(codes: np.ndarray) -> tuple:
    return tuple(int(c) for c in codes)


def canonical_kmer(codes: np.ndarray) -> tuple:
    f = kmer_tuple(codes)
    r = kmer_tuple(rc_codes(codes))
    return min(f, r)


def count_kmers(reads: List[np.ndarray], K: int) -> Counter:
    """Canonical K-mer counts; windows containing codes >=4 are skipped."""
    counts: Counter = Counter()
    for r in reads:
        r = np.asarray(r)
        for p in range(len(r) - K + 1):
            win = r[p : p + K]
            if (win >= 4).any():
                continue
            counts[canonical_kmer(win)] += 1
    return counts


def kmer_spectrum(counts: Counter, max_freq: int = 255) -> np.ndarray:
    spec = np.zeros(max_freq + 1, dtype=np.int64)
    for c in counts.values():
        spec[min(c, max_freq)] += 1
    return spec


def unipaths(kmer_set: Set[tuple], K: int) -> Set[tuple]:
    """All unipaths (maximal unbranched paths) of the bidirected de Bruijn
    graph over canonical `kmer_set`, as canonical base-code tuples.

    Oriented-node walk oracle: each canonical kmer yields two oriented nodes;
    an oriented edge x→y exists when y's (K-1)-prefix == x's (K-1)-suffix and
    canonical(y) in the set. A unipath edge additionally needs
    outdeg(x) == 1 and indeg(y) == 1.
    """
    def rc_t(t):
        return tuple(3 - b for b in reversed(t))

    def canon_t(t):
        return min(t, rc_t(t))

    oriented = set()
    for k in kmer_set:
        oriented.add(k)
        oriented.add(rc_t(k))

    def successors(x):
        out = []
        for b in range(4):
            y = x[1:] + (b,)
            if canon_t(y) in kmer_set:
                out.append(y)
        return out

    def predecessors(x):
        out = []
        for b in range(4):
            y = (b,) + x[:-1]
            if canon_t(y) in kmer_set:
                out.append(y)
        return out

    # chain edge x->y iff outdeg(x)==1, indeg(y)==1
    nxt = {}
    for x in oriented:
        s = successors(x)
        if len(s) == 1 and len(predecessors(s[0])) == 1:
            nxt[x] = s[0]
    prv = {y: x for x, y in nxt.items()}

    seen = set()
    out: Set[tuple] = set()
    for x in oriented:
        if x in seen:
            continue
        # walk back to head (guard cycles)
        h = x
        visited = {x}
        while h in prv:
            h = prv[h]
            if h in visited:  # cycle: break at lexicographic min node
                cyc = [h]
                c = nxt[h]
                while c != h:
                    cyc.append(c)
                    c = nxt[c]
                h = min(cyc)
                break
            visited.add(h)
        chain = [h]
        seen.add(h)
        c = h
        while c in nxt and nxt[c] not in (h,) and nxt[c] not in seen:
            c = nxt[c]
            chain.append(c)
            seen.add(c)
        seq = list(chain[0]) + [k[-1] for k in chain[1:]]
        out.add(canon_t(tuple(seq)))
    return out


def words_to_tuple(words_np, K: int) -> tuple:
    """Convert a packed multi-word kmer row (numpy uint32 per word) to codes."""
    from allpathslg_tpu_torch.kmer.bits import np_unpack
    return tuple(int(b) for b in np_unpack([int(w) for w in words_np], K))

"""Gapped alignment representation + affine traceback + printing (host).

Behavior contract (ref: src/PackAlign.{h,cc}, src/Alignment.{h,cc},
src/PrintAlignment.{h,cc} — SURVEY.md §2.2 "Packed alignment repr"): a
compact gapped alignment is (query start, target start, blocks), each block
a (gap, length) pair — `gap > 0` skips gap target bases (deletion w.r.t.
the query), `gap < 0` skips |gap| query bases (insertion w.r.t. the
target), then `length` aligned base pairs follow. The device kernels
(ops/banded.py, ops/affine.py) return cost summaries for batched use; this
module produces the explicit path for the places that need one — consensus
edits, eval error classification, alignment printing.

Costs match ops/affine.py: mismatch `sub_cost`, gap open `gap_open` once
per run + `gap_ext` per base, glocal (free target prefix/suffix; the whole
query aligns).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

INF = 1 << 30

BASES = "ACGTN"


@dataclasses.dataclass
class Alignment:
    """Packed gapped alignment (ref: class align in src/PackAlign.h)."""

    q_start: int
    t_start: int
    blocks: List[Tuple[int, int]]   # (gap, length) per block

    @property
    def q_end(self) -> int:
        n = self.q_start
        for g, l in self.blocks:
            if g < 0:
                n -= g
            n += l
        return n

    @property
    def t_end(self) -> int:
        n = self.t_start
        for g, l in self.blocks:
            if g > 0:
                n += g
            n += l
        return n

    def cigar(self) -> str:
        """CIGAR (M/I/D; I = extra query bases, D = extra target bases)."""
        out = []
        for g, l in self.blocks:
            if g > 0:
                out.append(f"{g}D")
            elif g < 0:
                out.append(f"{-g}I")
            if l > 0:
                out.append(f"{l}M")
        return "".join(out) or "*"

    def errors(self, q: np.ndarray, t: np.ndarray):
        """(mismatches, gap_opens, gap_bases) under this path."""
        q = np.asarray(q)
        t = np.asarray(t)
        mm = 0
        opens = 0
        gap_bases = 0
        qi, ti = self.q_start, self.t_start
        for g, l in self.blocks:
            if g != 0:
                opens += 1
                gap_bases += abs(g)
                if g > 0:
                    ti += g
                else:
                    qi -= g
            mm += int(np.sum(q[qi : qi + l] != t[ti : ti + l]))
            qi += l
            ti += l
        return mm, opens, gap_bases

    def cost(self, q, t, sub_cost=3, gap_open=4, gap_ext=1) -> int:
        mm, opens, gap_bases = self.errors(q, t)
        return mm * sub_cost + opens * gap_open + gap_bases * gap_ext


def affine_align_path(q, t, offset: int, band: int,
                      sub_cost: int = 3, gap_open: int = 4,
                      gap_ext: int = 1) -> Tuple[int, Alignment]:
    """Glocal banded affine DP with traceback (host numpy).

    Same cost semantics as ops/affine.affine_banded_align; returns
    (cost, Alignment). Raises ValueError if no in-band path exists.

    States: M = arrived diagonally, IX = inside a vertical run (query base
    against a target gap), IY = inside a horizontal run (target base
    against a query gap). Pointer matrices store the predecessor state.
    """
    q = np.asarray(q, np.int64)
    t = np.asarray(t, np.int64)
    Lq, Lt = len(q), len(t)
    M = np.full((Lq + 1, Lt + 1), INF, np.int64)
    IX = np.full((Lq + 1, Lt + 1), INF, np.int64)
    IY = np.full((Lq + 1, Lt + 1), INF, np.int64)
    pm = np.zeros((Lq + 1, Lt + 1), np.int8)
    px = np.zeros((Lq + 1, Lt + 1), np.int8)
    py = np.zeros((Lq + 1, Lt + 1), np.int8)
    for j in range(Lt + 1):
        if abs(j - offset) <= band:
            M[0, j] = 0
    for i in range(1, Lq + 1):
        jlo = max(0, i + offset - band)
        jhi = min(Lt, i + offset + band)
        for j in range(jlo, jhi + 1):
            # IX: consume q[i-1] against a target gap
            cands = (M[i - 1, j] + gap_open + gap_ext,
                     IX[i - 1, j] + gap_ext,
                     IY[i - 1, j] + gap_open + gap_ext)
            s = int(np.argmin(cands))
            if cands[s] < INF:
                IX[i, j] = cands[s]
                px[i, j] = s
            if j == 0:
                continue
            # M: diagonal from any state
            d = (M[i - 1, j - 1], IX[i - 1, j - 1], IY[i - 1, j - 1])
            s = int(np.argmin(d))
            if d[s] < INF:
                M[i, j] = d[s] + (0 if q[i - 1] == t[j - 1] else sub_cost)
                pm[i, j] = s
            # IY: consume t[j-1] against a query gap
            cands = (M[i, j - 1] + gap_open + gap_ext,
                     IX[i, j - 1] + gap_open + gap_ext,
                     IY[i, j - 1] + gap_ext)
            s = int(np.argmin(cands))
            if cands[s] < INF:
                IY[i, j] = cands[s]
                py[i, j] = s

    last = np.stack([M[Lq], IX[Lq], IY[Lq]])
    flat = int(last.argmin())
    state, j = flat // (Lt + 1), flat % (Lt + 1)
    cost = int(last[state, j])
    if cost >= INF:
        raise ValueError("no in-band alignment")

    i = Lq
    ops = []  # walked backwards
    while i > 0:
        if state == 0:
            ops.append("M")
            state = int(pm[i, j])
            i -= 1
            j -= 1
        elif state == 1:
            ops.append("I")
            state = int(px[i, j])
            i -= 1
        else:
            ops.append("D")
            state = int(py[i, j])
            j -= 1
    ops.reverse()
    t_start = j

    blocks: List[Tuple[int, int]] = []
    cur_gap, cur_len = 0, 0
    for op in ops:
        if op == "M":
            cur_len += 1
            continue
        if cur_len > 0:
            blocks.append((cur_gap, cur_len))
            cur_gap, cur_len = 0, 0
        d = 1 if op == "D" else -1
        if cur_gap != 0 and (cur_gap > 0) != (d > 0):
            blocks.append((cur_gap, 0))
            cur_gap = 0
        cur_gap += d
    blocks.append((cur_gap, cur_len))
    if len(blocks) > 1 and blocks[0] == (0, 0):
        blocks = blocks[1:]
    return cost, Alignment(q_start=0, t_start=t_start, blocks=blocks)


def print_alignment(q, t, aln: Alignment, width: int = 80) -> str:
    """3-line visual alignment (ref: src/PrintAlignment.{h,cc})."""
    q = np.asarray(q)
    t = np.asarray(t)
    ql, ml, tl = [], [], []
    qi, ti = aln.q_start, aln.t_start
    for g, l in aln.blocks:
        if g > 0:
            for _ in range(g):
                ql.append("-")
                ml.append(" ")
                tl.append(BASES[min(int(t[ti]), 4)])
                ti += 1
        elif g < 0:
            for _ in range(-g):
                ql.append(BASES[min(int(q[qi]), 4)])
                ml.append(" ")
                tl.append("-")
                qi += 1
        for _ in range(l):
            a, b = int(q[qi]), int(t[ti])
            ql.append(BASES[min(a, 4)])
            ml.append("|" if a == b else "*")
            tl.append(BASES[min(b, 4)])
            qi += 1
            ti += 1
    out = []
    for s in range(0, len(ql), width):
        out.append("Q " + "".join(ql[s : s + width]))
        out.append("  " + "".join(ml[s : s + width]))
        out.append("T " + "".join(tl[s : s + width]))
        out.append("")
    return "\n".join(out)

"""Scaffold structures and AGP/FASTA emission.

Superb (ref: src/Superb.{h,cc}, `.superb` files): a scaffold is an ordered
list of contigs with a gap estimate ± deviation at each junction. AGP is the
NCBI submission format the reference emits in SubmissionPrep (ref:
src/paths/SubmissionPrep.cc behavior, assembly.agp outputs).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from allpathslg_tpu_torch.dtypes.reads import string_from_codes


@dataclasses.dataclass
class Superb:
    """One scaffold: contig ids with per-junction gap (mean, dev).
    rc[i] marks a reverse-complemented placement."""
    contig_ids: List[int]
    rc: List[bool]
    gaps: List[int]        # len = len(contig_ids) - 1
    gap_devs: List[int]

    @property
    def n_contigs(self) -> int:
        return len(self.contig_ids)

    def length(self, contig_lens: Sequence[int]) -> int:
        total = sum(int(contig_lens[c]) for c in self.contig_ids)
        total += sum(max(int(g), 0) for g in self.gaps)
        return total


def scaffold_sequence(sb: Superb, contig_bases: Sequence[np.ndarray],
                      min_gap_ns: int = 20) -> np.ndarray:
    """Concatenate contigs with N-runs sized by the gap estimate (the
    reference floors printed gaps at a minimum N run)."""
    parts = []
    for i, cid in enumerate(sb.contig_ids):
        seq = np.asarray(contig_bases[cid], dtype=np.uint8)
        if sb.rc[i]:
            seq = (3 - seq)[::-1].copy()
            seq[seq > 3] = 4
        parts.append(seq)
        if i < len(sb.gaps):
            n_run = max(int(sb.gaps[i]), min_gap_ns)
            parts.append(np.full(n_run, 4, dtype=np.uint8))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def write_superb(path: str, scaffolds: Sequence[Superb]) -> None:
    with open(path, "w") as f:
        for si, sb in enumerate(scaffolds):
            f.write(f"scaffold {si} ncontigs {sb.n_contigs}\n")
            for i, cid in enumerate(sb.contig_ids):
                rc = "-" if sb.rc[i] else "+"
                f.write(f"  contig {cid} {rc}")
                if i < len(sb.gaps):
                    f.write(f" gap {sb.gaps[i]} dev {sb.gap_devs[i]}")
                f.write("\n")


def read_superb(path: str) -> List[Superb]:
    out: List[Superb] = []
    cur = None
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "scaffold":
                if cur is not None:
                    out.append(cur)
                cur = Superb([], [], [], [])
            elif t[0] == "contig" and cur is not None:
                cur.contig_ids.append(int(t[1]))
                cur.rc.append(t[2] == "-")
                if "gap" in t:
                    gi = t.index("gap")
                    cur.gaps.append(int(t[gi + 1]))
                    cur.gap_devs.append(int(t[t.index("dev") + 1]))
    if cur is not None:
        out.append(cur)
    return out


def write_agp(path: str, scaffolds: Sequence[Superb],
              contig_lens: Sequence[int], obj_prefix: str = "scaffold_",
              min_gap: int = 20) -> None:
    """AGP 2.0: one object per scaffold, W lines for contigs, N lines for
    gaps (ref: assembly.agp from SubmissionPrep)."""
    with open(path, "w") as f:
        f.write("##agp-version 2.0\n")
        for si, sb in enumerate(scaffolds):
            obj = f"{obj_prefix}{si}"
            pos = 1
            part = 1
            for i, cid in enumerate(sb.contig_ids):
                clen = int(contig_lens[cid])
                f.write(f"{obj}\t{pos}\t{pos + clen - 1}\t{part}\tW\t"
                        f"contig_{cid}\t1\t{clen}\t{'-' if sb.rc[i] else '+'}\n")
                pos += clen
                part += 1
                if i < len(sb.gaps):
                    g = max(int(sb.gaps[i]), min_gap)
                    f.write(f"{obj}\t{pos}\t{pos + g - 1}\t{part}\tN\t{g}\t"
                            f"scaffold\tyes\tpaired-ends\n")
                    pos += g
                    part += 1

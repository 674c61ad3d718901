"""FASTA/FASTQ host I/O (ref: src/Fastavector.{h,cc}, src/util/Fastb.cc —
fastb/qualb converters; here the in-memory form is code arrays)."""

from __future__ import annotations

import gzip
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from allpathslg_tpu_torch.dtypes.reads import codes_from_string, string_from_codes


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fasta(path: str) -> List[Tuple[str, np.ndarray]]:
    """[(name, codes uint8)] — codes 0..3, N/other → 4."""
    out = []
    name = None
    chunks: List[str] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, codes_from_string("".join(chunks))))
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            out.append((name, codes_from_string("".join(chunks))))
    return out


def write_fasta(path: str, records: Sequence[Tuple[str, np.ndarray]],
                width: int = 80) -> None:
    with _open(path, "wt") as f:
        for name, codes in records:
            f.write(f">{name}\n")
            s = string_from_codes(codes)
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")


def read_fastq(path: str, max_reads: Optional[int] = None
               ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Returns (list of code arrays, list of qual arrays)."""
    seqs, quals = [], []
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            s = f.readline().strip()
            f.readline()  # +
            q = f.readline().strip()
            seqs.append(codes_from_string(s))
            quals.append(np.frombuffer(q.encode(), dtype=np.uint8) - 33)
            if max_reads is not None and len(seqs) >= max_reads:
                break
    return seqs, quals


def write_fastq(path: str, records) -> None:
    """records: iterable of (name, codes, quals)."""
    with _open(path, "wt") as f:
        for name, codes, quals in records:
            q = (np.asarray(quals, dtype=np.uint8) + 33).tobytes().decode()
            f.write(f"@{name}\n{string_from_codes(codes)}\n+\n{q}\n")

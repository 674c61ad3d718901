"""The files a user hands the assembler: mate FASTQs, an unaligned SAM and
the library sheets, written with numpy byte matrices (one row a record).
Frozen copies of chip_smoke.py's write_fastq, write_pairs_sam and
write_sheets."""

from __future__ import annotations

from pathlib import Path

import numpy as np

ASCII_BASES = np.frombuffer(b"ACGTN", np.uint8)
ROWS_A_CHUNK = 1 << 19
LIB_HEADER = ("library_name,project_name,organism_name,type,paired,"
              "frag_size,frag_stddev,insert_size,insert_stddev,"
              "read_orientation,genomic_start,genomic_end\n")


def _digits(values, width: int) -> np.ndarray:
    """uint8 [n, width]: values as zero-padded decimal ASCII."""
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (np.asarray(values, np.int64)[:, None] // pw % 10
            + 48).astype(np.uint8)


def _text(n: int, text: bytes) -> np.ndarray:
    return np.tile(np.frombuffer(text, np.uint8), (n, 1))


def write_fastq(path, codes, quals, name: bytes, rows):
    """The reads `rows` as FASTQ records `@{name}{i:09d}`."""
    rows = np.asarray(rows)
    with open(path, "wb") as f:
        for s in range(0, len(rows), ROWS_A_CHUNK):
            pick = rows[s:s + ROWS_A_CHUNK]
            c, q = codes[pick], quals[pick]
            m = len(c)
            f.write(np.concatenate([
                _text(m, b"@" + name), _digits(np.arange(s, s + m), 9),
                _text(m, b"\n"), ASCII_BASES[np.minimum(c, 4)],
                _text(m, b"\n+\n"), (q + 33).astype(np.uint8),
                _text(m, b"\n")], axis=1).tobytes())


def write_pairs_sam(path, codes, quals, pairs, name: bytes):
    """Read pairs as unaligned SAM records: each pair's mates in turn with
    flags 0x1|0x40 and 0x1|0x80, the second mate of every odd pair stored
    reverse-complemented with 0x10 (the reader restores its sequenced
    orientation)."""
    with open(path, "wb") as f:
        f.write(b"@HD\tVN:1.6\tSO:unsorted\n")
        for s in range(0, len(pairs), ROWS_A_CHUNK):
            p = np.asarray(pairs[s:s + ROWS_A_CHUNK])
            m = len(p)
            qname = np.concatenate([_text(m, name),
                                    _digits(np.arange(s, s + m), 9)], axis=1)
            rc = (np.arange(s, s + m) % 2 == 1)[:, None]
            c1, q1 = codes[p[:, 1]], quals[p[:, 1]]
            c1 = np.where(rc, np.where(c1[:, ::-1] < 4, 3 - c1[:, ::-1], 4),
                          c1)
            q1 = np.where(rc, q1[:, ::-1], q1)
            recs = []
            for c, q, flag in ((codes[p[:, 0]], quals[p[:, 0]],
                                _text(m, b"65")),
                               (c1, q1, _digits(0x81 | 0x10 * rc[:, 0], 3))):
                recs += [qname, _text(m, b"\t"), flag,
                         _text(m, b"\t*\t0\t0\t*\t*\t0\t0\t"),
                         ASCII_BASES[np.minimum(c, 4)], _text(m, b"\t"),
                         (q + 33).astype(np.uint8), _text(m, b"\n")]
            f.write(np.concatenate(recs, axis=1).tobytes())


def write_sample_files(d: Path, frag: dict, jump: dict, frag_lib, jump_lib):
    """Fragment pairs as mate files frag_1.fastq / frag_2.fastq, jump pairs
    as jump.sam, and in_libs.csv / in_groups.csv naming them; frag_lib and
    jump_lib are (insert, sd)."""
    d.mkdir(parents=True, exist_ok=True)
    for mate in (0, 1):
        write_fastq(d / f"frag_{mate + 1}.fastq", frag["codes"],
                    frag["quals"], b"f", frag["pairs"][:, mate])
    write_pairs_sam(d / "jump.sam", jump["codes"], jump["quals"],
                    jump["pairs"], b"j")
    (d / "in_libs.csv").write_text(
        LIB_HEADER
        + f"frag,bench,sim,fragment,1,{frag_lib[0]},{frag_lib[1]},,,"
          "inward,,\n"
        + f"jump,bench,sim,jumping,1,,,{jump_lib[0]},{jump_lib[1]},"
          "outward,,\n")
    (d / "in_groups.csv").write_text(
        "group_name,library_name,file_name\n"
        "frag,frag,frag_?.fastq\n"
        "jump,jump,jump.sam\n")

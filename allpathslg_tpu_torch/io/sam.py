"""SAM import: alignments -> read arrays + pairing (port of
allpathslg_tpu/io/sam.py; host code).

Behavior contract (ref: src/lookup/SAM.{h,cc}, SAM2CRD.{h,cc}): parse SAM
records into reads, qualities and pairing for input prep. Reads mapped to
the reverse strand are flipped back to their sequenced orientation (SAM
stores SEQ reference-oriented); secondary and supplementary records are
skipped; pairing recovers (first, second) mates by QNAME. BAM arrives
through an external `samtools view` pipe, as in the reference.

Plain files go through `native/sam_reader.cpp` (built by native/build.py;
a failed build raises), which gives the Python parser's records, pairs and
names. Gzip files, and plain files the reader declines (a carriage
return, a byte >= 0x80, a FLAG that is not plain digits, a QUAL whose
length is not SEQ's, no kept record), go through the Python parser.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.dtypes.reads import (codes_from_string,
                                               string_from_codes)
from allpathslg_tpu_torch.native import build as nbuild

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_RC = 0x10
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _rc_codes(c: np.ndarray) -> np.ndarray:
    out = (3 - c[::-1].astype(np.int32)) % 4
    return np.where(c[::-1] > 3, 4, out).astype(np.uint8)


def read_sam(path: str, keep_duplicates: bool = True):
    """Parse a SAM file (optionally .gz) into read arrays, one record a
    line as the reference does.

    Returns (codes [N, Lmax] uint8, quals [N, Lmax] uint8, lengths [N],
    pairs [P, 2] int32, names list[str]). The span's counter reads_native
    or reads_python says which parser gave them.
    """
    path = str(path)
    with trace.span("ingest.sam", file=path) as sp:
        out = None if path.endswith(".gz") else _read_native(
            path, keep_duplicates)
        via = "reads_native"
        if out is None:
            out, via = _parse(path, keep_duplicates), "reads_python"
        sp.add("reads", len(out[2]))
        sp.add(via, len(out[2]))
        sp.add("bytes", os.path.getsize(path))
        return out


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _read_native(path: str, keep_duplicates: bool):
    """read_sam's 5-tuple from the native reader, or None where it
    declines the file."""
    lib = nbuild.sam_lib()
    n, lmax, nb = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
    fpath, keep = os.fsencode(path), int(bool(keep_duplicates))
    if lib.sam_scan(fpath, keep, ctypes.byref(n), ctypes.byref(lmax),
                    ctypes.byref(nb)) != 0:
        return None
    N, L = n.value, lmax.value
    codes = np.empty((N, L), np.uint8)
    quals = np.empty((N, L), np.uint8)
    lengths = np.empty(N, np.int32)
    pairs = np.empty((N // 2, 2), np.int32)
    names = np.empty(nb.value, np.uint8)
    n_pairs = ctypes.c_long()
    rc = lib.sam_load(fpath, keep, _ptr(codes, ctypes.c_ubyte),
                      _ptr(quals, ctypes.c_ubyte), _ptr(lengths, ctypes.c_int),
                      _ptr(pairs, ctypes.c_int), len(pairs),
                      ctypes.byref(n_pairs), _ptr(names, ctypes.c_char),
                      N, L, nb.value)
    if rc != 0:
        return None
    return (codes, quals, lengths, pairs[:n_pairs.value].copy(),
            names.tobytes().decode("ascii").split("\n"))


def _parse(path: str, keep_duplicates: bool):
    seqs: List[np.ndarray] = []
    quals: List[np.ndarray] = []
    names: List[str] = []
    mate_slot: Dict[Tuple[str, int], int] = {}
    pairs: List[Tuple[int, int]] = []

    with _open(str(path)) as f:
        for line in f:
            if not line or line[0] == "@":
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            qname, flag_s = fields[:2]
            seq, qual = fields[9], fields[10]
            flag = int(flag_s)
            if flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
                continue
            if not keep_duplicates and (flag & FLAG_DUP):
                continue
            if seq == "*":
                continue
            c = codes_from_string(seq)
            q = (np.frombuffer(qual.encode(), np.uint8) - 33
                 if qual != "*" else np.full(len(c), 30, np.uint8))
            if flag & FLAG_RC:  # restore sequenced orientation
                c = _rc_codes(c)
                q = q[::-1]
            idx = len(seqs)
            seqs.append(c)
            quals.append(np.asarray(q, np.uint8))
            names.append(qname)
            if flag & FLAG_PAIRED:
                mate = 1 if (flag & FLAG_FIRST) else 0
                key = (qname, mate)  # slot where our mate would register
                if key in mate_slot:
                    other = mate_slot.pop(key)
                    pairs.append((other, idx) if (flag & FLAG_SECOND)
                                 else (idx, other))
                else:
                    mate_slot[(qname, 0 if (flag & FLAG_FIRST) else 1)] = idx

    n = len(seqs)
    lmax = max((len(s) for s in seqs), default=0)
    codes = np.full((n, lmax), 4, np.uint8)
    qarr = np.zeros((n, lmax), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, (c, q) in enumerate(zip(seqs, quals)):
        codes[i, : len(c)] = c
        qarr[i, : len(q)] = q
        lengths[i] = len(c)
    parr = (np.asarray(pairs, np.int32) if pairs
            else np.zeros((0, 2), np.int32))
    return codes, qarr, lengths, parr, names


def read_bam(path: str, samtools: str = "samtools"):
    """BAM through a `samtools view` pipe (as the reference's SAM2CRD
    import). Needs samtools on PATH."""
    proc = subprocess.Popen([samtools, "view", "-h", path],
                            stdout=subprocess.PIPE, text=True)
    with tempfile.NamedTemporaryFile("w", suffix=".sam", delete=False) as tf:
        for line in proc.stdout:
            tf.write(line)
        tmp = tf.name
    try:
        if proc.wait() != 0:
            raise RuntimeError(f"samtools view failed on {path}")
        return read_sam(tmp)
    finally:
        os.unlink(tmp)


def write_sam(path: str, codes: np.ndarray, lengths: np.ndarray,
              quals: Optional[np.ndarray] = None,
              names: Optional[List[str]] = None) -> None:
    """Emit unaligned SAM records (export surface for interop)."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for i in range(codes.shape[0]):
            l = int(lengths[i])
            name = names[i] if names else f"read_{i}"
            seq = string_from_codes(codes[i, :l])
            q = ("".join(chr(33 + int(x)) for x in quals[i, :l])
                 if quals is not None else "*")
            f.write(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{q}\n")

"""FASTQ ingest through the native C++ reader (port of
allpathslg_tpu/io/native_fastq.py).

Plain files go through `native/fastq_reader.cpp` (built by native/build.py;
a failed build raises). Gzip files, and plain files the reader rejects or
finds empty, go through the Python parser, as in the reference. The two
paths differ where the reference's do: the native reader clamps qualities
to [0, 60]; the Python parser keeps them as they are and wraps a quality
below '!' in uint8.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.io import fasta as pio
from allpathslg_tpu_torch.native import build as nbuild


def _read_native(path: str):
    """(codes, quals, lengths), or None where the reference falls back."""
    lib = nbuild.fastq_lib()
    n = ctypes.c_long()
    ml = ctypes.c_long()
    rc = lib.fastq_scan(path.encode(), ctypes.byref(n), ctypes.byref(ml))
    if rc != 0 or n.value <= 0:
        return None
    N, L = n.value, max(ml.value, 1)
    codes = np.empty((N, L), np.uint8)
    quals = np.empty((N, L), np.uint8)
    lengths = np.empty(N, np.int32)
    rc = lib.fastq_load(
        path.encode(),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        quals.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), N, L)
    return (codes, quals, lengths) if rc == 0 else None


def read_fastq_arrays(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes [N, Lmax] uint8, quals [N, Lmax] uint8, lengths [N] int32)."""
    path = str(path)
    with trace.span("ingest.fastq", file=path) as sp:
        out = _read_arrays(path)
        sp.add("reads", len(out[2]))
        sp.add("bytes", os.path.getsize(path))
        return out


def _read_arrays(path: str):
    if not path.endswith(".gz"):
        got = _read_native(path)
        if got is not None:
            return got
    seqs, qs = pio.read_fastq(path)
    N = len(seqs)
    L = max((len(s) for s in seqs), default=1)
    codes = np.full((N, L), 4, np.uint8)
    quals = np.zeros((N, L), np.uint8)
    lengths = np.zeros(N, np.int32)
    for i, (s, q) in enumerate(zip(seqs, qs)):
        codes[i, : len(s)] = s
        quals[i, : len(q)] = q
        lengths[i] = len(s)
    return codes, quals, lengths

"""Build and load the port's native host libraries (C++ through ctypes).

`fastq_reader.cpp` and `radix_sort.cpp` (copies of the reference's) and
`sam_reader.cpp` (the port's own) are each compiled with `g++ -O3
-march=native -shared -fPIC` at first use into `build/native/`
(gitignored), under a name that carries a hash of the source and the
flags, as ops/cuda/nvcc.py names the kernels: an edit rebuilds, and
nothing is ever written into the package directory. The compile goes to a
temporary name and is renamed into place. A failed build raises with the
compiler's stderr; there is no fallback (the reference falls back to numpy
when its library is missing; the port does not).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIBS = {}


def build(name: str) -> Path:
    """Compile `native/<name>.cpp` if its library is missing; its path."""
    src_path = _DIR / f"{name}.cpp"
    src = src_path.read_bytes()
    tag = hashlib.sha1(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(src_path), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src_path}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]


def fastq_lib() -> ctypes.CDLL:
    """The FASTQ reader, with the reference's argtypes."""
    lib = load("fastq_reader")
    lib.fastq_scan.restype = ctypes.c_int
    lib.fastq_scan.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_long),
                               ctypes.POINTER(ctypes.c_long)]
    lib.fastq_load.restype = ctypes.c_int
    lib.fastq_load.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_ubyte),
                               ctypes.POINTER(ctypes.c_ubyte),
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.c_long, ctypes.c_long]
    return lib


def sam_lib() -> ctypes.CDLL:
    """The SAM reader (io/sam.read_sam's plain files)."""
    lib = load("sam_reader")
    long_p = ctypes.POINTER(ctypes.c_long)
    lib.sam_scan.restype = ctypes.c_int
    lib.sam_scan.argtypes = [ctypes.c_char_p, ctypes.c_int,
                             long_p, long_p, long_p]
    lib.sam_load.restype = ctypes.c_int
    lib.sam_load.argtypes = [ctypes.c_char_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_ubyte),
                             ctypes.POINTER(ctypes.c_ubyte),
                             ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int), ctypes.c_long,
                             long_p, ctypes.POINTER(ctypes.c_char),
                             ctypes.c_long, ctypes.c_long, ctypes.c_long]
    return lib


def radix_lib() -> ctypes.CDLL:
    """The host LSD radix sort, with the reference's argtypes."""
    lib = load("radix_sort")
    lib.radix_sort_u64.restype = ctypes.c_int
    lib.radix_sort_u64.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int64]
    return lib


# Below this many keys the reference sorts with numpy's stable argsort
# (its native/build.py:67); the two sorts give the same order
NATIVE_SORT_MIN = 1 << 14


def sort_u64_with_payload(keys, payload):
    """Stable sort of uint64 keys with an int64 payload: the native radix
    sort from NATIVE_SORT_MIN keys, numpy's stable argsort below. As in the
    reference, the native sort works in place on the arrays when they
    already are contiguous uint64 / int64. Returns (keys, payload)
    sorted."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    payload = np.ascontiguousarray(payload, dtype=np.int64)
    if len(keys) < NATIVE_SORT_MIN:
        order = np.argsort(keys, kind="stable")
        return keys[order], payload[order]
    radix_lib().radix_sort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(keys)))
    return keys, payload

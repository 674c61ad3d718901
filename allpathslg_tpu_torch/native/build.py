"""Build and load the port's compiled libraries: the native host ones here
(C++ through ctypes) and, through ops/cuda/nvcc.py, the CUDA kernels.

`fastq_reader.cpp` and `radix_sort.cpp` (copies of the reference's),
`sam_reader.cpp` and `pack_reads.cpp` (the port's own) are each compiled
with `g++ -O3 -march=native -shared -fPIC` at first use into
`build/native/` (gitignored), under a name that carries a hash of the
source and the flags: an edit rebuilds, and nothing is ever written into
the package directory. The compile goes to a temporary name that carries
the process and the thread, and is renamed into place. A failed build
raises with the compiler's stderr; there is no fallback (the reference
falls back to numpy when its library is missing; the port does not).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def compile_library(compiler: str, src_path: Path, flags: list,
                    out_dir: Path) -> tuple:
    """Compile `src_path` with `compiler` and `flags` into `out_dir` if its
    library is missing: (path, seconds spent; 0.0 when already built)."""
    src = src_path.read_bytes()
    tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    out = out_dir / f"lib{src_path.stem}_{tag}.so"
    if out.exists():
        return out, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([compiler, *flags, "-o", str(tmp),
                               str(src_path)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed for "
                               f"{src_path}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out, time.perf_counter() - t0


class Loader:
    """`library()`: on the first call, under a lock, the library of
    `build(name)` loaded and passed through `bind` (which declares its C
    functions' types and returns it); after that, `lib`, without the lock.
    A tuning script may set `lib` to a bound variant build."""

    def __init__(self, build, name: str, bind):
        self._build, self._name, self._bind = build, name, bind
        self._lock = threading.Lock()
        self.lib = None

    def __call__(self):
        lib = self.lib
        if lib is not None:
            return lib
        with self._lock:
            if self.lib is None:
                path, _ = self._build(self._name)
                self.lib = self._bind(ctypes.CDLL(str(path)))
            return self.lib


def build(name: str) -> tuple:
    """Compile `native/<name>.cpp` if its library is missing: (path, s)."""
    return compile_library("g++", _DIR / f"{name}.cpp", CXX_FLAGS,
                           BUILD_DIR)


def _bind_fastq(lib):
    """The FASTQ reader, with the reference's argtypes."""
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


def _bind_sam(lib):
    """The SAM reader (io/sam.read_sam's plain files)."""
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


def _bind_pack(lib):
    """The read packer behind dtypes/packed.pack_codes and pack_quals."""
    u8, u32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
    i64 = ctypes.c_int64
    lib.pack_codes.restype = None
    lib.pack_codes.argtypes = [u8, i64, i64, i64, u32, u32]
    lib.qual_palette.restype = ctypes.c_int
    lib.qual_palette.argtypes = [u8, i64, i64, i64, u8]
    lib.pack_nibbles.restype = None
    lib.pack_nibbles.argtypes = [u8, i64, i64, i64, u8, ctypes.c_int, u32]
    return lib


def _bind_radix(lib):
    """The host LSD radix sort, with the reference's argtypes."""
    lib.radix_sort_u64.restype = ctypes.c_int
    lib.radix_sort_u64.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int64]
    return lib


fastq_lib = Loader(build, "fastq_reader", _bind_fastq)
sam_lib = Loader(build, "sam_reader", _bind_sam)
radix_lib = Loader(build, "radix_sort", _bind_radix)
pack_lib = Loader(build, "pack_reads", _bind_pack)


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

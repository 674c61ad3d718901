"""Build and load the port's native host library (C++ through ctypes).

`fastq_reader.cpp` (a copy of the reference's) is compiled with
`g++ -O3 -march=native -shared -fPIC` at first use into `build/native/`
(gitignored), under a name that carries a hash of the source and the
flags, as ops/cuda/nvcc.py names the kernels: an edit rebuilds, and
nothing is ever written into the package directory. The compile goes to a
temporary name and is renamed into place. A failed build raises with the
compiler's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

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

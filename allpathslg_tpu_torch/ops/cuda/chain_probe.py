"""Probes of the card for the general banded DP's chain bound.

`csrc/chain_probe.cu`, built like the kernels (ops/cuda/nvcc.py) and bound
with ctypes: `dpx_chain(n)` runs n dependent DPX instructions on one thread
and returns the clock64 cycles they took; `empty()` launches a kernel that
does nothing. chip_smoke.chain_terms times both with device_ms. Nothing in
the pipeline calls them, and they need a CUDA device.
"""

from __future__ import annotations

import ctypes

import torch

from allpathslg_tpu_torch.ops.cuda import nvcc

_SOURCE = "chain_probe.cu"
_lib = None


def build() -> tuple:
    """Compile the probes if their library is missing: (path, seconds)."""
    return nvcc.build(_SOURCE)


def library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.chain_probe_dpx.argtypes = [ci, ci, ci, vp, vp, vp]
        lib.chain_probe_dpx.restype = ci
        lib.chain_probe_empty.argtypes = [vp]
        lib.chain_probe_empty.restype = ci
        _lib = lib
    return _lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"chain_probe: {what} failed with CUDA error {err}")


class DpxChain:
    """n dependent __viaddmin_s32 on one thread of the current device."""

    def __init__(self, n: int):
        if n <= 0 or n % 16:
            raise ValueError(f"DpxChain: n={n} must be a positive multiple "
                             f"of 16")
        self.n = n
        self.out = torch.zeros(1, dtype=torch.int32, device="cuda")
        self.cycles = torch.zeros(1, dtype=torch.int64, device="cuda")

    def __call__(self):
        stream = torch.cuda.current_stream().cuda_stream
        _check(library().chain_probe_dpx(self.n, 1, 1 << 30,
                                         self.out.data_ptr(),
                                         self.cycles.data_ptr(), stream),
               "dpx chain launch")

    def cycles_per_step(self) -> float:
        """clock64 cycles a dependent DPX instruction, from the last call
        (the check x == n holds the chain to its length)."""
        torch.cuda.synchronize()
        if int(self.out) != self.n:
            raise RuntimeError(f"chain_probe: chain gave {int(self.out)}, "
                               f"want {self.n}")
        return int(self.cycles) / self.n


def empty():
    _check(library().chain_probe_empty(torch.cuda.current_stream()
                                       .cuda_stream), "empty launch")

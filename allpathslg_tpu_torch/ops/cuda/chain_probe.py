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


def bind(lib):
    """Declare the C functions' argument and result types on a loaded
    library of csrc/chain_probe.cu; returns it."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.chain_probe_dpx.argtypes = [ci, ci, ci, vp, vp, vp]
    lib.chain_probe_dpx.restype = ci
    lib.chain_probe_empty.argtypes = [vp]
    lib.chain_probe_empty.restype = ci
    return lib


library = nvcc.loader(_SOURCE, bind)


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
        nvcc.check(library().chain_probe_dpx(self.n, 1, 1 << 30,
                                             self.out.data_ptr(),
                                             self.cycles.data_ptr(), stream),
                   "chain_probe: dpx chain launch")

    def cycles_per_step(self) -> float:
        """clock64 cycles a dependent DPX instruction, from the last call
        (the check x == n holds the chain to its length)."""
        torch.cuda.synchronize()
        if int(self.out) != self.n:
            raise RuntimeError(f"chain_probe: chain gave {int(self.out)}, "
                               f"want {self.n}")
        return int(self.cycles) / self.n


def empty():
    nvcc.check(library().chain_probe_empty(torch.cuda.current_stream()
                                           .cuda_stream),
               "chain_probe: empty launch")

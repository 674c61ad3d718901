"""Hopper general banded alignment: the counterpart of
`allpathslg_tpu/ops/pallas/banded_pallas.py::banded_align_pallas`.

The kernel is `allpathslg_tpu_torch/csrc/banded_general.cu`, compiled with
`nvcc` for `sm_90a` into a plain-C shared library under `build/kernels/`
at first use (ops/cuda/nvcc.py) and bound with ctypes. `banded_align_general`
is the wrapper: tensors on the CPU go to `banded_general_plain`, the plain
PyTorch version of the same contract (`ops/banded.banded_align` as it is);
tensors on a CUDA device launch the kernel, and a kernel that does not
build or launch raises. There is no fallback.

Contract (both versions, as the jnp `banded_align` of the JAX package):
integer-cost banded glocal DP for any band up to MAX_BAND and any
`sub_cost`/`gap_cost` in 0..MAX_COST. q uint8 [B, Lq], t uint8 [B, Lt],
q_len, t_len, offset integer [B] -> (cost int32 [B], t_end int32 [B]),
with (1 << 20, -1) when no in-band path exists. Codes are compared as they
are, so a query code 4 matches a target code 4 (the bit-parallel kernel's
query code 4 matches nothing; ROADMAP.md Queue 3).
"""

from __future__ import annotations

import ctypes

import torch

from allpathslg_tpu_torch.ops import banded
from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.ops.cuda import nvcc

MAX_BAND = 255         # 2 * band + 1 slots over 32 lanes x 16 registers
MAX_COST = 1024        # with MAX_LQ, keeps every cell inside int32
MAX_LQ = 1 << 20
_SOURCE = "banded_general.cu"

_KERNEL = "banded_general"  # name in allpathslg_tpu_torch/trace.py
_lib = None


def launch_count() -> int:
    """Kernel launches made through `banded_align_general` since the last
    reset."""
    return trace.count(_KERNEL)


def reset_launch_count() -> None:
    trace.reset(_KERNEL)


def banded_general_plain(q, q_len, t, t_len, offset, band: int = 16,
                         sub_cost: int = 1, gap_cost: int = 1):
    """Plain PyTorch version: `ops/banded.banded_align`."""
    return banded.banded_align(q, q_len, t, t_len, offset, band=band,
                               sub_cost=sub_cost, gap_cost=gap_cost)


def banded_align_general(q, q_len, t, t_len, offset, band: int = 16,
                         sub_cost: int = 1, gap_cost: int = 1):
    """(cost int32 [B], t_end int32 [B]); see the module docstring."""
    if q.device.type == "cpu":
        return banded_general_plain(q, q_len, t, t_len, offset, band,
                                    sub_cost, gap_cost)
    if q.device.type != "cuda":
        raise ValueError(f"banded_align_general: no kernel for device "
                         f"{q.device}")
    return _banded_general_cuda(q, q_len, t, t_len, offset, band, sub_cost,
                                gap_cost)


def _banded_general_cuda(q, q_len, t, t_len, offset, band: int,
                         sub_cost: int, gap_cost: int):
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"banded_align_general: band={band} not in "
                         f"0..{MAX_BAND}")
    for name, c in (("sub_cost", sub_cost), ("gap_cost", gap_cost)):
        if not 0 <= int(c) <= MAX_COST:
            raise ValueError(f"banded_align_general: {name}={c} not in "
                             f"0..{MAX_COST}")
    if q.dtype != torch.uint8 or t.dtype != torch.uint8:
        raise ValueError(f"banded_align_general: q and t must be uint8, got "
                         f"{q.dtype} and {t.dtype}")
    if (q.dim() != 2 or t.dim() != 2 or t.shape[0] != q.shape[0]
            or t.shape[1] < 1):
        raise ValueError(f"banded_align_general: want q [B, Lq] and t "
                         f"[B, Lt >= 1], got {tuple(q.shape)} and "
                         f"{tuple(t.shape)}")
    B, Lq = q.shape
    Lt = t.shape[1]
    if Lq > MAX_LQ:
        raise ValueError(f"banded_align_general: Lq={Lq} above {MAX_LQ}")
    dev = q.device
    scal = []
    for name, x in (("q_len", q_len), ("t_len", t_len), ("offset", offset)):
        if x.shape != (B,) or x.device != dev:
            raise ValueError(f"banded_align_general: {name} must be [{B}] "
                             f"on {dev}")
        scal.append(x.to(torch.int32).contiguous())
    q = q.contiguous()
    t = t.contiguous()
    cost = torch.empty(B, dtype=torch.int32, device=dev)
    t_end = torch.empty(B, dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.banded_general_launch(
            q.data_ptr(), t.data_ptr(), scal[0].data_ptr(),
            scal[1].data_ptr(), scal[2].data_ptr(), cost.data_ptr(),
            t_end.data_ptr(), B, Lq, Lt, band, int(sub_cost), int(gap_cost),
            stream)
    if err != 0:
        msg = lib.banded_general_error_string(err).decode()
        raise RuntimeError(f"banded_general_launch failed: CUDA error {err} "
                           f"({msg})")
    trace.record(_KERNEL)
    return cost, t_end


def build() -> tuple:
    """Compile the kernel if its library is missing: (path, seconds spent)."""
    return nvcc.build(_SOURCE)


def bind(lib):
    """Declare the C functions' argument and result types on a loaded
    library of csrc/banded_general.cu (this one or an earlier version, for
    scripts/tune_banded_general.py); returns it."""
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    lib.banded_general_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                          ci, ci, ci, ci, ci, ci, vp]
    lib.banded_general_launch.restype = ci
    lib.banded_general_error_string.argtypes = [ci]
    lib.banded_general_error_string.restype = ctypes.c_char_p
    lib.banded_general_max_band.restype = ci
    if lib.banded_general_max_band() != MAX_BAND:
        raise RuntimeError("banded_general: library and wrapper disagree "
                           "on the largest band")
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib

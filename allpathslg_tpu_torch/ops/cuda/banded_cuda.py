"""Hopper bit-parallel banded alignment: the counterpart of
`allpathslg_tpu/ops/pallas/banded_bp.py::banded_align_bp`.

The kernel is `allpathslg_tpu_torch/csrc/banded_bp.cu`, compiled with
`nvcc` for `sm_90a` into a plain-C shared library under `build/kernels/`
at first use (ops/cuda/nvcc.py) and bound with ctypes. `banded_align_bp`
is the wrapper: tensors on the CPU go to `banded_align_bp_plain`, the
plain PyTorch version of the same contract; tensors on a CUDA device
launch the kernel, and a kernel that does not build or launch raises.
There is no fallback.

Contract (both versions, as the TPU kernel's): unit-cost banded glocal
edit distance, band <= 15. q uint8 [B, Lq], t uint8 [B, Lt], q_len,
t_len, offset integer [B] -> (cost int32 [B], t_end int32 [B]), with
(1 << 20, -1) when no in-band path exists, for 0 <= q_len <= Lq (the
range every caller gives). A query code >= 4 matches nothing. This
differs from the general `ops/banded.banded_align`, which lets a query
code 4 match a target code 4 (the JAX package has the same two
behaviours; ROADMAP.md Queue 3): the plain version here is
`banded_align` on a query whose codes >= 4 are replaced by -1.
"""

from __future__ import annotations

import ctypes

import torch

from allpathslg_tpu_torch.ops import banded
from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.ops.cuda import nvcc

MAX_BAND = 15          # K = 2 * band + 1 slots must fit one uint32
_SOURCE = "banded_bp.cu"

_KERNEL = "banded_bp"  # name in allpathslg_tpu_torch/trace.py
_lib = None


def launch_count() -> int:
    """Kernel launches made through `banded_align_bp` since the last reset."""
    return trace.count(_KERNEL)


def reset_launch_count() -> None:
    trace.reset(_KERNEL)


def banded_align_bp_plain(q, q_len, t, t_len, offset, band: int = 15):
    """Plain PyTorch version: the general banded DP at unit costs on a
    query in which no code >= 4 can match."""
    if band > MAX_BAND:
        raise ValueError(f"banded_align_bp: band={band} > {MAX_BAND}")
    qn = torch.where(q >= 4, -1, q.to(torch.int16))
    return banded.banded_align(qn, q_len, t, t_len, offset, band=band)


def banded_align_bp(q, q_len, t, t_len, offset, band: int = 15):
    """(cost int32 [B], t_end int32 [B]); see the module docstring."""
    if q.device.type == "cpu":
        return banded_align_bp_plain(q, q_len, t, t_len, offset, band)
    if q.device.type != "cuda":
        raise ValueError(f"banded_align_bp: no kernel for device {q.device}")
    return _banded_align_bp_cuda(q, q_len, t, t_len, offset, band)


def _banded_align_bp_cuda(q, q_len, t, t_len, offset, band: int):
    if not 0 <= band <= MAX_BAND:
        raise ValueError(f"banded_align_bp: band={band} not in 0..{MAX_BAND}")
    if q.dtype != torch.uint8 or t.dtype != torch.uint8:
        raise ValueError(f"banded_align_bp: q and t must be uint8, got "
                         f"{q.dtype} and {t.dtype}")
    if q.dim() != 2 or t.dim() != 2 or t.shape[0] != q.shape[0]:
        raise ValueError(f"banded_align_bp: want q [B, Lq] and t [B, Lt], "
                         f"got {tuple(q.shape)} and {tuple(t.shape)}")
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    scal = []
    for name, x in (("q_len", q_len), ("t_len", t_len), ("offset", offset)):
        if x.shape != (B,) or x.device != dev:
            raise ValueError(f"banded_align_bp: {name} must be [{B}] on {dev}")
        scal.append(x.to(torch.int32).contiguous())
    q = q.contiguous()
    t = t.contiguous()
    cost = torch.empty(B, dtype=torch.int32, device=dev)
    t_end = torch.empty(B, dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.banded_bp_launch(
            q.data_ptr(), t.data_ptr(), scal[0].data_ptr(),
            scal[1].data_ptr(), scal[2].data_ptr(), cost.data_ptr(),
            t_end.data_ptr(), B, Lq, Lt, band, stream)
    if err != 0:
        msg = lib.banded_bp_error_string(err).decode()
        raise RuntimeError(f"banded_bp_launch failed: CUDA error {err} "
                           f"({msg})")
    trace.record(_KERNEL)
    return cost, t_end


def build() -> tuple:
    """Compile the kernel if its library is missing: (path, seconds spent)."""
    return nvcc.build(_SOURCE)


def bind(lib):
    """Declare the C functions' argument and result types on a loaded
    library of csrc/banded_bp.cu; returns it."""
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    lib.banded_bp_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                     ci, ci, ci, ci, vp]
    lib.banded_bp_launch.restype = ci
    lib.banded_bp_error_string.argtypes = [ci]
    lib.banded_bp_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib

"""Hopper pileup of placed reads' base votes: polish's per-column count.

The kernel is `allpathslg_tpu_torch/csrc/pileup.cu`, compiled with `nvcc`
for `sm_90a` into a plain-C shared library under `build/kernels/` at first
use (ops/cuda/nvcc.py) and bound with ctypes. It replaces no TPU kernel:
the JAX package counts the votes with a host numpy bincount
(`allpathslg_tpu/asm/polish.py::_pileup_segments`). `pileup` is the
wrapper: tensors on the CPU go to `pileup_plain`, the plain PyTorch
version of the same contract; tensors on a CUDA device launch the kernel,
and a kernel that does not build or launch raises. There is no fallback.

Contract (both versions): `offsets` int64 [n_contigs + 1] (contig c is
global positions [offsets[c], offsets[c + 1])); the N rows of `codes`
uint8 [N, L], `lengths`, `contig`, `anchor` int32 [N] (lengths <= L), `rc`
bool [N] and `starts` int64 [N] are placed reads, sorted by `starts`, the
leftmost global position each can cover: offsets[contig] + (rc ? anchor -
(length - 1) : anchor). Returns int32 votes [s1 - s0, 4]: votes[p - s0, b]
counts the bases j < length of the reads with code b at global position p
in [s0, s1) and inside their own contig, where base j of a read lands at
offsets[contig] + anchor + j, or at offsets[contig] + anchor - j with code
3 - code for a reverse-complemented read; codes >= 4 cast no vote.
"""

from __future__ import annotations

import ctypes

import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.ops.cuda import nvcc

_SOURCE = "pileup.cu"
_KERNEL = "pileup"  # name in allpathslg_tpu_torch/trace.py
_CHUNK = 262144     # reads a step of the plain version (bounds its memory)


def pileup_plain(offsets, codes, lengths, contig, anchor, rc, starts,
                 s0: int, s1: int):
    """Plain PyTorch version: a bincount of (position * 4 + base) over the
    valid bases of the reads that can reach [s0, s1), _CHUNK reads at a
    time."""
    L = codes.shape[1]
    lo, hi = torch.searchsorted(
        starts, torch.tensor([s0 - L, s1], device=starts.device)).tolist()
    j = torch.arange(L, device=codes.device)[None, :]
    votes = torch.zeros((s1 - s0) * 4, dtype=torch.int64,
                        device=codes.device)
    for s in range(lo, hi, _CHUNK):
        rows = slice(s, min(s + _CHUNK, hi))
        flip = rc[rows][:, None]
        anc = anchor[rows].long()[:, None]
        base = codes[rows].long()
        base = torch.where(flip & (base < 4), 3 - base, base)
        ci = contig[rows].long()
        cs = offsets[ci][:, None]
        gpos = cs + torch.where(flip, anc - j, anc + j)
        valid = ((j < lengths[rows][:, None]) & (base < 4) & (gpos >= cs)
                 & (gpos < offsets[ci + 1][:, None])
                 & (gpos >= s0) & (gpos < s1))
        votes += torch.bincount((gpos[valid] - s0) * 4 + base[valid],
                                minlength=(s1 - s0) * 4)
    return votes.view(-1, 4).to(torch.int32)


def pileup(offsets, codes, lengths, contig, anchor, rc, starts, s0: int,
           s1: int):
    """int32 votes [s1 - s0, 4]; see the module docstring."""
    if codes.device.type == "cpu":
        return pileup_plain(offsets, codes, lengths, contig, anchor, rc,
                            starts, s0, s1)
    if codes.device.type != "cuda":
        raise ValueError(f"pileup: no kernel for device {codes.device}")
    return _pileup_cuda(offsets, codes, lengths, contig, anchor, rc, starts,
                        s0, s1)


def _pileup_cuda(offsets, codes, lengths, contig, anchor, rc, starts,
                 s0: int, s1: int):
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"pileup: codes must be uint8 [N, L], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    N, L = codes.shape
    dev = codes.device
    want = {"offsets": (offsets, torch.int64, None),
            "lengths": (lengths, torch.int32, N),
            "contig": (contig, torch.int32, N),
            "anchor": (anchor, torch.int32, N),
            "rc": (rc, torch.bool, N),
            "starts": (starts, torch.int64, N)}
    for name, (x, dtype, n) in want.items():
        if x.dtype != dtype or x.dim() != 1 or x.device != dev \
                or (n is not None and x.shape[0] != n):
            raise ValueError(f"pileup: {name} must be {dtype} "
                             f"[{'n' if n is None else n}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not 0 <= s0 <= s1:
        raise ValueError(f"pileup: bad segment [{s0}, {s1})")
    ins = [x.contiguous() for x in (offsets, codes, lengths, contig, anchor,
                                    rc, starts)]
    votes = torch.empty((s1 - s0, 4), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pileup_launch(*(x.data_ptr() for x in ins), N, L, s0, s1,
                                votes.data_ptr(), stream)
    nvcc.check(err, "pileup_launch", lib.pileup_error_string)
    trace.record(_KERNEL)
    return votes


def bind(lib):
    """Declare the C functions' argument and result types on a loaded
    library of csrc/pileup.cu; returns it."""
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.pileup_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64,
                                  ctypes.c_int, i64, i64, vp, vp]
    lib.pileup_launch.restype = ctypes.c_int
    lib.pileup_error_string.argtypes = [ctypes.c_int]
    lib.pileup_error_string.restype = ctypes.c_char_p
    return lib


library = nvcc.loader(_SOURCE, bind)

"""Hopper radix sort of 64-bit keys: the counterpart of
`allpathslg_tpu/ops/pallas/sort_pallas.py::sort_two_words`.

The kernel is `allpathslg_tpu_torch/csrc/radix_sort.cu`, compiled with
`nvcc` for `sm_90a` into a plain-C shared library under `build/kernels/`
at first use (ops/cuda/nvcc.py) and bound with ctypes. `radix_sort` is the
wrapper: a key tensor on the CPU goes to `radix_sort_plain`, the plain
PyTorch version of the same contract; a key tensor on a CUDA device launches the kernel, and
a kernel that does not build or launch raises. There is no fallback.

Contract (both versions): `keys` is int64 [n] holding an unsigned key of
`key_bits` bits (32: one uint32 word; 64: `(w0 << 32) | w1` over the uint32
bit patterns, so the int64 is negative when w0 >= 2**31). Returns the keys
sorted ascending as unsigned integers and the STABLE permutation (int32,
sorted position -> input position). Stability lets the one sort serve every
call site: key-only sorts, payload sorts by gather, and keys of more than
two words by composing passes (ops/sort.py).
"""

from __future__ import annotations

import ctypes

import torch

from allpathslg_tpu_torch.ops.cuda import launches, nvcc

_SIGN = -(1 << 63)          # int64 with only the top bit set
_SOURCE = "radix_sort.cu"

_KERNEL = "radix_sort"  # name in ops/cuda/launches.py
_lib = None


def launch_count() -> int:
    """Kernel launches made through `radix_sort` since the last reset."""
    return launches.count(_KERNEL)


def reset_launch_count() -> None:
    launches.reset(_KERNEL)


def radix_sort_plain(keys: torch.Tensor, key_bits: int):
    """Plain PyTorch version: a stable `torch.sort` over the key with its top
    bit flipped, so that signed int64 order is the unsigned key order."""
    del key_bits  # the flip orders 32- and 64-bit keys alike
    flipped, perm = torch.sort(keys ^ _SIGN, stable=True)
    return flipped ^ _SIGN, perm.to(torch.int32)


def radix_sort(keys: torch.Tensor, key_bits: int):
    """(sorted keys int64 [n], perm int32 [n]); see the module docstring."""
    if keys.device.type == "cpu":
        return radix_sort_plain(keys, key_bits)
    if keys.device.type != "cuda":
        raise ValueError(f"radix_sort: no kernel for device {keys.device}")
    return _radix_sort_cuda(keys, key_bits)


def _radix_sort_cuda(keys: torch.Tensor, key_bits: int):
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"radix_sort: want int64 [n], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if key_bits not in (32, 64):
        raise ValueError("radix_sort: key_bits must be 32 or 64")
    n = keys.numel()
    if n >= 1 << 31:
        raise ValueError(f"radix_sort: {n} keys exceed the int32 index")
    keys = keys.contiguous()
    lib = library()
    dev = keys.device
    n_tiles = max(1, -(-n // lib.radix_sort_tile_keys()))
    keys_a = torch.empty_like(keys)
    keys_b = torch.empty_like(keys)
    idx_a = torch.empty(n, dtype=torch.int32, device=dev)
    idx_b = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(256 * n_tiles, dtype=torch.int32, device=dev)
    totals = torch.empty(256, dtype=torch.int32, device=dev)
    diff = torch.empty(1, dtype=torch.int64, device=dev)
    in_b = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radix_sort_u64(
            keys.data_ptr(), keys_a.data_ptr(), idx_a.data_ptr(),
            keys_b.data_ptr(), idx_b.data_ptr(), counts.data_ptr(),
            totals.data_ptr(), diff.data_ptr(), n, key_bits, stream,
            ctypes.byref(in_b))
    if err != 0:
        msg = lib.radix_sort_error_string(err).decode()
        raise RuntimeError(f"radix_sort_u64 failed: CUDA error {err} ({msg})")
    launches.record(_KERNEL)
    return (keys_b, idx_b) if in_b.value else (keys_a, idx_a)


def build() -> tuple:
    """Compile the kernel if its library is missing: (path, seconds spent)."""
    return nvcc.build(_SOURCE)


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp = ctypes.c_void_p
        lib.radix_sort_u64.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                       ctypes.c_int64, ctypes.c_int, vp,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.radix_sort_u64.restype = ctypes.c_int
        lib.radix_sort_tile_keys.argtypes = []
        lib.radix_sort_tile_keys.restype = ctypes.c_int
        lib.radix_sort_error_string.argtypes = [ctypes.c_int]
        lib.radix_sort_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib

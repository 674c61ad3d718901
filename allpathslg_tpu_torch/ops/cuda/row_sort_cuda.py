"""Hopper batched row sort of 64-bit keys: the counterpart of the
`lax.sort(dimension=1)` row sorts of `allpathslg_tpu/ops/bucket_count.py`
(group_keys, :73 and :117).

The kernel is `allpathslg_tpu_torch/csrc/row_sort.cu`, a reduce-then-scan
LSD radix sort of every row at once, compiled with `nvcc` for `sm_90a` into
a plain-C shared library under `build/kernels/` at first use
(ops/cuda/nvcc.py) and bound with ctypes. `row_sort` is the wrapper: a key
tensor on the CPU goes to `row_sort_plain`, the plain PyTorch version of
the same contract; a key tensor on a CUDA device launches the kernel, and a
kernel that does not build or launch raises. There is no fallback.

Contract (both versions): `keys` is int64 [rows, row_len] holding an
unsigned key of `key_bits` bits (32: one uint32 word; 64: `(w0 << 32) | w1`
over the uint32 bit patterns). Returns each row's keys sorted ascending as
unsigned integers, and the STABLE permutation within the row (int32,
sorted place -> input place). The all-ones key is the largest, so it sorts
last in its row.

On the card a sort is: one histogram kernel over the whole matrix, one read
of it to the host (the sort's only synchronise), `sort_cuda.plan_passes`
on it, then three launches (count, scan, scatter) per planned pass, each
across all rows.
"""

from __future__ import annotations

import ctypes

import torch

from allpathslg_tpu_torch.ops.cuda import launches, nvcc, sort_cuda

_SIGN = -(1 << 63)          # int64 with only the top bit set
_SOURCE = "row_sort.cu"
MAX_KEYS = 1 << 31          # rows * row_len; the histogram counts are 32-bit

_KERNEL = "row_sort"  # name in ops/cuda/launches.py
_lib = None


def row_sort_plain(keys: torch.Tensor, key_bits: int):
    """Plain PyTorch version: a stable `torch.sort` along each row with the
    top bit flipped, so that signed int64 order is the unsigned key order."""
    del key_bits  # the flip orders 32- and 64-bit keys alike
    flipped, perm = torch.sort(keys ^ _SIGN, dim=1, stable=True)
    return flipped ^ _SIGN, perm.to(torch.int32)


def row_sort(keys: torch.Tensor, key_bits: int):
    """(sorted keys int64 [rows, row_len], perm int32 [rows, row_len]); see
    the module docstring."""
    if keys.device.type == "cpu":
        return row_sort_plain(keys, key_bits)
    if keys.device.type != "cuda":
        raise ValueError(f"row_sort: no kernel for device {keys.device}")
    return _row_sort_cuda(keys, key_bits)


def _check(keys: torch.Tensor, key_bits: int):
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise ValueError(f"row_sort: want int64 [rows, row_len], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if key_bits not in (32, 64):
        raise ValueError("row_sort: key_bits must be 32 or 64")
    if keys.numel() >= MAX_KEYS:
        raise ValueError(f"row_sort: {keys.numel()} keys; the kernel takes "
                         f"fewer than 2**31")
    return keys.contiguous()


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.row_sort_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _row_sort_cuda(keys: torch.Tensor, key_bits: int):
    keys = _check(keys, key_bits)
    rows, row_len = keys.shape
    dev = keys.device
    if keys.numel() == 0:
        return keys.clone(), torch.empty((rows, row_len), dtype=torch.int32,
                                         device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        hist = torch.empty(lib.row_sort_hist_words(), dtype=torch.int32,
                           device=dev)
        _raise_on(lib, lib.row_sort_histogram(
            keys.data_ptr(), rows, row_len, key_bits, hist.data_ptr(),
            stream), "row_sort_histogram")
        launches.record(_KERNEL, size=keys.numel())
        # the outputs are allocated while the histogram runs
        keys_a, keys_b = torch.empty_like(keys), torch.empty_like(keys)
        idx_a = torch.empty((rows, row_len), dtype=torch.int32, device=dev)
        idx_b = torch.empty_like(idx_a)
        scratch = torch.empty(lib.row_sort_scratch_words(rows, row_len),
                              dtype=torch.int32, device=dev)
        host = hist.cpu().numpy()           # the sort's one synchronise
        digits = host[:-1].reshape(-1, 1 << sort_cuda.RADIX_BITS)
        shifts = sort_cuda.plan_passes(digits[: key_bits // 8],
                                       int(host[-1]), keys.numel(), key_bits)
        if not shifts:      # every key equal: each row's order is sorted
            return keys.clone(), torch.arange(
                row_len, dtype=torch.int32,
                device=dev).expand(rows, row_len).contiguous()
        err = lib.row_sort_passes(
            keys.data_ptr(), keys_a.data_ptr(), idx_a.data_ptr(),
            keys_b.data_ptr(), idx_b.data_ptr(), scratch.data_ptr(), rows,
            row_len, key_bits, (ctypes.c_int * len(shifts))(*shifts),
            len(shifts), stream)
    _raise_on(lib, err, "row_sort_passes")
    # pass j writes buffer a when j is even, b when it is odd
    return (keys_a, idx_a) if len(shifts) % 2 else (keys_b, idx_b)


def build() -> tuple:
    """Compile the kernel if its library is missing: (path, seconds spent)."""
    return nvcc.build(_SOURCE)


def bind(lib):
    """Declare the C functions' argument and result types on a loaded
    library of csrc/row_sort.cu; returns it."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.row_sort_histogram.argtypes = [vp, i64, i64, i32, vp, vp]
    lib.row_sort_histogram.restype = i32
    lib.row_sort_passes.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32,
                                    ctypes.POINTER(i32), i32, vp]
    lib.row_sort_passes.restype = i32
    lib.row_sort_hist_words.argtypes = []
    lib.row_sort_hist_words.restype = i32
    lib.row_sort_scratch_words.argtypes = [i64, i64]
    lib.row_sort_scratch_words.restype = i64
    lib.row_sort_error_string.argtypes = [i32]
    lib.row_sort_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib

"""Hopper radix sort of 64-bit keys: the counterpart of
`allpathslg_tpu/ops/pallas/sort_pallas.py::sort_two_words`.

The kernel is `allpathslg_tpu_torch/csrc/radix_sort.cu`, a one-sweep LSD
radix sort, compiled with `nvcc` for `sm_90a` into a plain-C shared library
under `build/kernels/` at first use (ops/cuda/nvcc.py) and bound with
ctypes. `radix_sort` is the wrapper: a key tensor on the CPU goes to
`radix_sort_plain`, the plain PyTorch version of the same contract; a key
tensor on a CUDA device launches the kernel, and a kernel that does not
build or launch raises. There is no fallback.

Contract (both versions): `keys` is int64 [n] holding an unsigned key of
`key_bits` bits (32: one uint32 word; 64: `(w0 << 32) | w1` over the uint32
bit patterns, so the int64 is negative when w0 >= 2**31). Returns the keys
sorted ascending as unsigned integers and the STABLE permutation (int32,
sorted position -> input position). Stability lets the one sort serve every
call site: key-only sorts, payload sorts by gather, and keys of more than
two words by composing passes (ops/sort.py).

On the card a sort is: one histogram kernel over every digit position,
one read of it to the host (the sort's only synchronise), `plan_passes`,
then one kernel per planned pass.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.ops.cuda import nvcc

_SIGN = -(1 << 63)          # int64 with only the top bit set
_SOURCE = "radix_sort.cu"
RADIX_BITS = 8
MAX_KEYS = 1 << 30          # the kernel's look-back counts have 30 bits

_KERNEL = "radix_sort"  # name in allpathslg_tpu_torch/trace.py
_lib = None


def launch_count() -> int:
    """Kernel launches made through `radix_sort` since the last reset."""
    return trace.count(_KERNEL)


def reset_launch_count() -> None:
    trace.reset(_KERNEL)


def radix_sort_plain(keys: torch.Tensor, key_bits: int):
    """Plain PyTorch version: a stable `torch.sort` over the key with its top
    bit flipped, so that signed int64 order is the unsigned key order."""
    del key_bits  # the flip orders 32- and 64-bit keys alike
    flipped, perm = torch.sort(keys ^ _SIGN, stable=True)
    return flipped ^ _SIGN, perm.to(torch.int32)


def all_ones(key_bits: int) -> int:
    """The all-ones key (the pipeline's padding sentinel) as an int64."""
    return -1 if key_bits == 64 else (1 << key_bits) - 1


def digit_histogram_plain(keys: torch.Tensor, key_bits: int):
    """Plain version of the kernel's histogram: (int64 numpy
    [key_bits // 8, 256] counts of each 8-bit digit value at each position,
    least significant first, over the keys that are not all-ones; the
    number of all-ones keys)."""
    is_ones = keys == all_ones(key_bits)
    rest = keys[~is_ones]
    hist = torch.stack([torch.bincount((rest >> s) & 0xFF, minlength=256)
                        for s in range(0, key_bits, RADIX_BITS)])
    return hist.cpu().numpy(), int(is_ones.sum())


def plan_passes(hist, n_ones: int, n: int, key_bits: int) -> list:
    """The digit shifts, least significant first, that the kernel sorts by;
    the only place that decides which passes run.

    hist: [key_bits // 8, 256] counts of each digit value at each position
    over the n - n_ones keys that are not all-ones (digit_histogram_plain's
    layout). A position is skipped when one bucket holds all those keys:
    they agree there, so the planned digits order them fully. The all-ones
    key is the unique largest; every pass puts it in a bucket after 255,
    so all-ones keys land last, in input order. Keys that need no digit but
    hold both kinds take one pass (shift 0) for that partition alone. An
    empty plan means the input order is already the sorted order."""
    rows = np.asarray(hist).reshape(-1, 1 << RADIX_BITS)
    differ = rows[: key_bits // RADIX_BITS].max(axis=1) < n - n_ones
    shifts = [int(p) * RADIX_BITS for p in np.flatnonzero(differ)]
    if not shifts and 0 < n_ones < n:
        shifts = [0]
    return shifts


def radix_sort(keys: torch.Tensor, key_bits: int):
    """(sorted keys int64 [n], perm int32 [n]); see the module docstring."""
    if keys.device.type == "cpu":
        return radix_sort_plain(keys, key_bits)
    if keys.device.type != "cuda":
        raise ValueError(f"radix_sort: no kernel for device {keys.device}")
    return _radix_sort_cuda(keys, key_bits)


def _check(keys: torch.Tensor, key_bits: int):
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"radix_sort: want int64 [n], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if key_bits not in (32, 64):
        raise ValueError("radix_sort: key_bits must be 32 or 64")
    if keys.numel() >= MAX_KEYS:
        raise ValueError(f"radix_sort: {keys.numel()} keys; the kernel "
                         f"takes fewer than 2**30")
    return keys.contiguous()


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.radix_sort_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def digit_histogram(keys: torch.Tensor, key_bits: int):
    """digit_histogram_plain's result, from the histogram kernel for a
    CUDA tensor of n >= 1 keys."""
    if keys.device.type == "cpu":
        return digit_histogram_plain(keys, key_bits)
    keys = _check(keys, key_bits)
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        _start_histogram(lib, keys, key_bits, stream)
        hist, n_ones = _read_histogram(lib, key_bits, stream)
    return hist.astype(np.int64), n_ones


def _start_histogram(lib, keys: torch.Tensor, key_bits: int, stream: int):
    """A new work buffer (the histogram, then the passes' look-back
    scratch), zeroed, with the histogram kernel started into its head."""
    work = torch.empty(lib.radix_sort_work_words(keys.numel(), key_bits),
                       dtype=torch.int32, device=keys.device)
    _raise_on(lib, lib.radix_sort_histogram(
        keys.data_ptr(), keys.numel(), key_bits, work.data_ptr(), stream),
        "radix_sort_histogram")
    return work


def _read_histogram(lib, key_bits: int, stream: int):
    """Waits for the histogram kernel (the sort's one synchronise):
    (hist rows [key_bits // 8, 256], count of all-ones keys)."""
    host = np.empty(lib.radix_sort_hist_words(), np.int32)
    _raise_on(lib, lib.radix_sort_read_histogram(host.ctypes.data, stream),
              "radix_sort_read_histogram")
    rows = host[:-1].reshape(-1, 1 << RADIX_BITS)[: key_bits // RADIX_BITS]
    return rows, int(host[-1])


def _radix_sort_cuda(keys: torch.Tensor, key_bits: int):
    keys = _check(keys, key_bits)
    n = keys.numel()
    dev = keys.device
    if n == 0:
        return keys.clone(), torch.empty(0, dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        work = _start_histogram(lib, keys, key_bits, stream)
        trace.record(_KERNEL, size=n)
        # the outputs are allocated while the histogram runs
        keys_a, keys_b = torch.empty_like(keys), torch.empty_like(keys)
        idx_a = torch.empty(n, dtype=torch.int32, device=dev)
        idx_b = torch.empty_like(idx_a)
        hist, n_ones = _read_histogram(lib, key_bits, stream)
        shifts = plan_passes(hist, n_ones, n, key_bits)
        if not shifts:          # every key equal: the input order is sorted
            return keys.clone(), torch.arange(n, dtype=torch.int32,
                                              device=dev)
        err = lib.radix_sort_passes(
            keys.data_ptr(), keys_a.data_ptr(), idx_a.data_ptr(),
            keys_b.data_ptr(), idx_b.data_ptr(), work.data_ptr(), n,
            key_bits, (ctypes.c_int * len(shifts))(*shifts), len(shifts),
            stream)
    _raise_on(lib, err, "radix_sort_passes")
    # pass j writes buffer a when j is even, b when it is odd
    return (keys_a, idx_a) if len(shifts) % 2 else (keys_b, idx_b)


def build() -> tuple:
    """Compile the kernel if its library is missing: (path, seconds spent)."""
    return nvcc.build(_SOURCE)


def bind(lib):
    """Declare the C functions' argument and result types on a loaded
    library of csrc/radix_sort.cu; returns it."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.radix_sort_histogram.argtypes = [vp, i64, i32, vp, vp]
    lib.radix_sort_histogram.restype = i32
    lib.radix_sort_read_histogram.argtypes = [vp, vp]
    lib.radix_sort_read_histogram.restype = i32
    lib.radix_sort_passes.argtypes = [vp, vp, vp, vp, vp, vp, i64, i32,
                                      ctypes.POINTER(i32), i32, vp]
    lib.radix_sort_passes.restype = i32
    lib.radix_sort_hist_words.argtypes = []
    lib.radix_sort_hist_words.restype = i32
    lib.radix_sort_work_words.argtypes = [i64, i32]
    lib.radix_sort_work_words.restype = i64
    lib.radix_sort_error_string.argtypes = [i32]
    lib.radix_sort_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = bind(ctypes.CDLL(str(path)))
    return _lib

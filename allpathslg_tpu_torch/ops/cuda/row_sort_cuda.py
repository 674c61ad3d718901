"""Hopper batched row sort of 64-bit keys: the counterpart of the
`lax.sort(dimension=1)` row sorts of `allpathslg_tpu/ops/bucket_count.py`
(group_keys, :73 and :117).

The kernel is `allpathslg_tpu_torch/csrc/row_sort.cu`, a one-sweep LSD
radix sort of every row at once with a look-back scoped to the row,
compiled with `nvcc` for `sm_90a` into a plain-C shared library under
`build/kernels/` at first use (ops/cuda/nvcc.py) and bound with ctypes.
`row_sort` is the wrapper: a key tensor on the CPU goes to
`row_sort_plain`, the plain PyTorch version of the same contract; a key
tensor on a CUDA device launches the kernel, and a kernel that does not
build or launch raises. There is no fallback.

Contract (both versions): `keys` is int64 [rows, row_len] holding an
unsigned key of `key_bits` bits (32: one uint32 word; 64: `(w0 << 32) | w1`
over the uint32 bit patterns). Returns each row's keys sorted ascending as
unsigned integers, and the STABLE permutation within the row (int32,
sorted place -> input place). The all-ones key is the largest, so it sorts
last in its row. With `idx` (int32 [rows, row_len]) the permutation is
composed with it: place j of a row gets idx at the input place of the key
sorted there, so that stable passes over word groups compose without a
gather (ops/sort.sort_rows_by_words).

On the card a sort is: a memset of one scratch buffer (`scratch_layout`),
the histogram kernel (each row's digit counts), the bases kernel (each
row's bucket starts, and the union of the rows), one read of the union to
the host (the sort's only synchronise), `sort_cuda.plan_passes` on it, then
one kernel per planned pass, each across all rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.ops.cuda import nvcc, sort_cuda

_SIGN = -(1 << 63)          # int64 with only the top bit set
_SOURCE = "row_sort.cu"
RADIX = 1 << sort_cuda.RADIX_BITS
BUCKETS = RADIX + 1         # the all-ones bucket after bucket 255
HIST_WORDS = 8 * RADIX + 1  # the union: 8 x 256 counts, then all-ones
MAX_KEYS = 1 << 31          # rows * row_len; the histogram counts are 32-bit
MAX_ROW_LEN = 1 << 30       # the look-back counts a row's keys in 30 bits

_KERNEL = "row_sort"  # name in allpathslg_tpu_torch/trace.py


class Layout(NamedTuple):
    """Word offsets in the sort's one int32 scratch buffer: the union
    histogram at 0 (HIST_WORDS), row_hist (rows x (positions * 256 + 1)),
    status (one region of status_stride words a digit position: rows x
    tiles x 257 look-back words, then the pass's tile counter), bases (rows
    x positions x 257). The words before bases are zeroed; bases is written
    whole."""
    row_hist: int
    status: int
    status_stride: int
    bases: int
    total: int


def scratch_layout(rows: int, row_len: int, key_bits: int,
                   tile: int) -> Layout:
    """The scratch buffer of a sort of [rows, row_len] keys of key_bits
    bits in tiles of `tile` keys of a row (the kernel's
    row_sort_tile_keys())."""
    positions = key_bits // sort_cuda.RADIX_BITS
    tiles = -(-row_len // tile)
    row_hist = HIST_WORDS
    status = row_hist + rows * (positions * RADIX + 1)
    stride = rows * tiles * BUCKETS + 1
    bases = status + positions * stride
    total = bases + rows * positions * BUCKETS
    return Layout(row_hist, status, stride, bases, total)


class RowHistogram(NamedTuple):
    """The histogram and bases kernels' results: counts int64 [rows,
    positions, 256] of each digit value at each position over each row's
    keys that are not all-ones; ones [rows] all-ones keys a row; bases
    [rows, positions, 257] each bucket's start in its row (the all-ones
    bucket last); union numpy [positions, 256], the rows' counts summed;
    n_ones, all-ones keys in all."""
    counts: torch.Tensor
    ones: torch.Tensor
    bases: torch.Tensor
    union: np.ndarray
    n_ones: int


def row_histogram_plain(keys: torch.Tensor, key_bits: int) -> RowHistogram:
    """Plain version of the histogram and bases kernels."""
    rows = keys.shape[0]
    is_ones = keys == sort_cuda.all_ones(key_bits)
    digits = torch.stack([(keys >> s) & (RADIX - 1)
                          for s in range(0, key_bits, sort_cuda.RADIX_BITS)],
                         1)                          # [rows, positions, R]
    counts = torch.zeros(rows, digits.shape[1], RADIX, dtype=torch.int64,
                         device=keys.device)
    counts.scatter_add_(2, digits, (~is_ones).long()[:, None].expand_as(
        digits).contiguous())
    bases = torch.cat([torch.zeros_like(counts[..., :1]),
                       counts.cumsum(2)], 2)
    return RowHistogram(counts, is_ones.sum(1), bases,
                        counts.sum(0).cpu().numpy(), int(is_ones.sum()))


def row_sort_plain(keys: torch.Tensor, key_bits: int,
                   idx: Optional[torch.Tensor] = None):
    """Plain PyTorch version: a stable `torch.sort` along each row with the
    top bit flipped, so that signed int64 order is the unsigned key order;
    then idx gathered by the permutation, when given."""
    del key_bits  # the flip orders 32- and 64-bit keys alike
    flipped, perm = torch.sort(keys ^ _SIGN, dim=1, stable=True)
    if idx is not None:
        return flipped ^ _SIGN, _check_idx(idx, keys).gather(1, perm)
    return flipped ^ _SIGN, perm.to(torch.int32)


def row_sort(keys: torch.Tensor, key_bits: int,
             idx: Optional[torch.Tensor] = None):
    """(sorted keys int64 [rows, row_len], perm int32 [rows, row_len]); see
    the module docstring."""
    if keys.device.type == "cpu":
        return row_sort_plain(keys, key_bits, idx)
    if keys.device.type != "cuda":
        raise ValueError(f"row_sort: no kernel for device {keys.device}")
    return _row_sort_cuda(keys, key_bits, idx)


def _check(keys: torch.Tensor, key_bits: int):
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise ValueError(f"row_sort: want int64 [rows, row_len], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if key_bits not in (32, 64):
        raise ValueError("row_sort: key_bits must be 32 or 64")
    if keys.numel() >= MAX_KEYS or keys.shape[1] >= MAX_ROW_LEN:
        raise ValueError(f"row_sort: {tuple(keys.shape)} keys; the kernel "
                         f"takes fewer than 2**31, rows of fewer than 2**30")
    return keys.contiguous()


def _check_idx(idx: torch.Tensor, keys: torch.Tensor):
    if (idx.dtype != torch.int32 or idx.shape != keys.shape
            or idx.device != keys.device):
        raise ValueError(f"row_sort: idx must be int32 {tuple(keys.shape)} "
                         f"on {keys.device}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    return idx.contiguous()


def _at(buf: torch.Tensor, words: int) -> int:
    """The address of word `words` of an int32 buffer."""
    return buf.data_ptr() + 4 * words


def _start_histogram(lib, keys: torch.Tensor, key_bits: int, stream: int):
    """A new scratch buffer, its head zeroed, with the histogram and bases
    kernels and the union's copy to the host started: (buffer, layout)."""
    rows, row_len = keys.shape
    lay = scratch_layout(rows, row_len, key_bits, lib.row_sort_tile_keys())
    work = torch.empty(lay.total, dtype=torch.int32, device=keys.device)
    nvcc.check(lib.row_sort_histogram(
        keys.data_ptr(), rows, row_len, key_bits, work.data_ptr(), lay.bases,
        _at(work, lay.row_hist), _at(work, lay.bases), stream),
        "row_sort_histogram", lib.row_sort_error_string)
    return work, lay


def _read_histogram(lib, key_bits: int, stream: int):
    """Waits for the union (the sort's one synchronise): (union [key_bits
    // 8, 256], count of all-ones keys)."""
    host = np.empty(HIST_WORDS, np.int32)
    nvcc.check(lib.row_sort_read_histogram(host.ctypes.data, stream),
               "row_sort_read_histogram", lib.row_sort_error_string)
    union = host[:-1].reshape(-1, RADIX)[: key_bits // sort_cuda.RADIX_BITS]
    return union, int(host[-1])


def row_histogram(keys: torch.Tensor, key_bits: int) -> RowHistogram:
    """row_histogram_plain's result, from the histogram and bases kernels
    for a CUDA tensor."""
    if keys.device.type == "cpu":
        return row_histogram_plain(keys, key_bits)
    keys = _check(keys, key_bits)
    rows, positions = keys.shape[0], key_bits // sort_cuda.RADIX_BITS
    lib = library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        work, lay = _start_histogram(lib, keys, key_bits, stream)
        union, n_ones = _read_histogram(lib, key_bits, stream)
    per_row = work[lay.row_hist:lay.status].view(rows, -1).long()
    return RowHistogram(
        per_row[:, :-1].reshape(rows, positions, RADIX), per_row[:, -1],
        work[lay.bases:lay.total].view(rows, positions, BUCKETS).long(),
        union.astype(np.int64), n_ones)


def _row_sort_cuda(keys: torch.Tensor, key_bits: int,
                   idx: Optional[torch.Tensor]):
    keys = _check(keys, key_bits)
    idx = None if idx is None else _check_idx(idx, keys)
    rows, row_len = keys.shape
    dev = keys.device
    if keys.numel() == 0:
        return keys.clone(), (torch.empty((rows, row_len), dtype=torch.int32,
                                          device=dev)
                              if idx is None else idx.clone())
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        work, lay = _start_histogram(lib, keys, key_bits, stream)
        trace.record(_KERNEL, size=keys.numel())
        # the outputs are allocated while the histogram runs
        keys_a, keys_b = torch.empty_like(keys), torch.empty_like(keys)
        idx_a = torch.empty((rows, row_len), dtype=torch.int32, device=dev)
        idx_b = torch.empty_like(idx_a)
        union, n_ones = _read_histogram(lib, key_bits, stream)
        shifts = sort_cuda.plan_passes(union, n_ones, keys.numel(), key_bits)
        if not shifts:      # every key equal: each row's order is sorted
            return keys.clone(), (torch.arange(
                row_len, dtype=torch.int32, device=dev).expand(
                    rows, row_len).contiguous()
                if idx is None else idx.clone())
        err = lib.row_sort_passes(
            keys.data_ptr(), None if idx is None else idx.data_ptr(),
            keys_a.data_ptr(), idx_a.data_ptr(), keys_b.data_ptr(),
            idx_b.data_ptr(), _at(work, lay.bases), _at(work, lay.status),
            lay.status_stride, rows, row_len, key_bits,
            (ctypes.c_int * len(shifts))(*shifts), len(shifts), stream)
    nvcc.check(err, "row_sort_passes", lib.row_sort_error_string)
    # pass j writes buffer a when j is even, b when it is odd
    return (keys_a, idx_a) if len(shifts) % 2 else (keys_b, idx_b)


def bind(lib):
    """Declare the C functions' argument and result types on a loaded
    library of csrc/row_sort.cu; returns it."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.row_sort_histogram.argtypes = [vp, i64, i64, i32, vp, i64, vp, vp,
                                       vp]
    lib.row_sort_histogram.restype = i32
    lib.row_sort_read_histogram.argtypes = [vp, vp]
    lib.row_sort_read_histogram.restype = i32
    lib.row_sort_passes.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i64, i64,
                                    i64, i32, ctypes.POINTER(i32), i32, vp]
    lib.row_sort_passes.restype = i32
    lib.row_sort_tile_keys.argtypes = []
    lib.row_sort_tile_keys.restype = i32
    lib.row_sort_error_string.argtypes = [i32]
    lib.row_sort_error_string.restype = ctypes.c_char_p
    return lib


library = nvcc.loader(_SOURCE, bind)

"""2-bit packed read transfer (port of allpathslg_tpu/dtypes/packed.py).

Codes are 0..3 = ACGT, 4 = N/pad (dtypes/reads.py convention). words[i,w]
carries bases 16w..16w+15 of read i, base j in bits 2*(j%16)..+1;
nmask[i,w] carries bases 32w..32w+31, bit j%32 set when code==4. Lossless
for any [N, L] uint8 code matrix; bit-identical to the reference.

The host packing (pack_codes, pack_quals, qual_palette_size) runs in
native/pack_reads.cpp, one pass over each row, in a span upload.pack
(counters reads and bytes_in); its output is the reference's numpy
packing's, bit for bit. On the device the uint32 words are int64 tensors
holding the uint32 values (kmer/bits.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.native import build as nbuild


def _rows(a: np.ndarray):
    """uint8 `a` as rows the native packer walks: (a view whose rows each
    hold their bytes contiguously, or a contiguous copy; its row stride)."""
    if a.shape[1] > 1 and a.strides[1] != 1:
        a = np.ascontiguousarray(a)
    return a, a.strides[0]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pack_codes(codes: np.ndarray):
    """Host pack: [N, L] uint8 (0..4) -> (words [N, ceil(L/16)] uint32,
    nmask [N, ceil(L/32)] uint32, L). The nmask is always emitted at full
    width, so consecutive batches keep one shape."""
    codes = np.asarray(codes, np.uint8)
    n, L = codes.shape
    words = np.empty((n, (L + 15) // 16), np.uint32)
    nmask = np.empty((n, (L + 31) // 32), np.uint32)
    with trace.span("upload.pack") as sp:
        sp.add("reads", n)
        sp.add("bytes_in", n * L)
        rows, stride = _rows(codes)
        nbuild.pack_lib().pack_codes(
            _ptr(rows, ctypes.c_uint8), n, L, stride,
            _ptr(words, ctypes.c_uint32), _ptr(nmask, ctypes.c_uint32))
    return words, nmask, L


def to_device_words(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words -> int64 tensor on `device` (values unchanged)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def unpack_codes(words: torch.Tensor, nmask: torch.Tensor, L: int):
    """Device unpack: -> [N, L] uint8 codes 0..4."""
    j = torch.arange(L, device=words.device)
    base = ((words[:, j // 16] >> ((j % 16) * 2)) & 3).to(torch.uint8)
    if nmask.shape[1] == 0:
        return base
    isn = (nmask[:, j // 32] >> (j % 32)) & 1
    return torch.where(isn != 0, 4, base).to(torch.uint8)


def pack_codes_device(codes: torch.Tensor):
    """Device-side pack for the return path of batch programs (corrected
    reads): -> (words [N, ceil(L/16)], nmask [N, ceil(L/32)]) as int64.
    The shifted addends occupy disjoint bits, so the sum is an OR."""
    n, L = codes.shape
    Wb = (L + 15) // 16
    Wn = (L + 31) // 32
    dev = codes.device
    cp = torch.zeros((n, Wb * 16), dtype=torch.int64, device=dev)
    cp[:, :L] = codes.long() & 3
    sh = (torch.arange(Wb * 16, device=dev) % 16) * 2
    words = (cp << sh).view(n, Wb, 16).sum(2)
    npad = torch.zeros((n, Wn * 32), dtype=torch.int64, device=dev)
    npad[:, :L] = (codes == 4).long()
    shn = torch.arange(Wn * 32, device=dev) % 32
    nmask = (npad << shn).view(n, Wn, 32).sum(2)
    return words, nmask


def unpack_codes_host(words: np.ndarray, nmask: np.ndarray, L: int):
    """Host-side numpy mirror of unpack_codes."""
    words = np.asarray(words)
    nmask = np.asarray(nmask)
    j = np.arange(L, dtype=np.uint32)
    base = ((words[:, j // 16] >> ((j % 16) * 2)) & 3).astype(np.uint8)
    if nmask.shape[1] == 0:
        return base
    isn = (nmask[:, j // 32] >> (j % 32)) & 1
    return np.where(isn != 0, np.uint8(4), base)


def qual_palette_size(quals: np.ndarray) -> int:
    """The number of distinct values in uint8 quals [N, L]."""
    quals = np.asarray(quals, np.uint8)
    n, L = quals.shape
    rows, stride = _rows(quals)
    palette = np.zeros(256, np.uint8)
    return nbuild.pack_lib().qual_palette(
        _ptr(rows, ctypes.c_uint8), n, L, stride,
        _ptr(palette, ctypes.c_uint8))


def pack_quals(quals: np.ndarray):
    """Host pack quals via a 4-bit palette (ref: feudal QualNibbleVec).
    Returns (nibbles [N, ceil(L/8)] uint32, palette [16] uint8, L), or
    (None, quals, L) raw fallback when >16 distinct values exist."""
    quals = np.asarray(quals, np.uint8)
    n, L = quals.shape
    nib = np.empty((n, (L + 7) // 8), np.uint32)
    palette = np.zeros(256, np.uint8)
    with trace.span("upload.pack") as sp:
        sp.add("reads", n)
        sp.add("bytes_in", n * L)
        lib = nbuild.pack_lib()
        rows, stride = _rows(quals)
        src = _ptr(rows, ctypes.c_uint8)
        pal = _ptr(palette, ctypes.c_uint8)
        k = lib.qual_palette(src, n, L, stride, pal)
        if k > 16:
            return None, quals, L
        lib.pack_nibbles(src, n, L, stride, pal, k, _ptr(nib, ctypes.c_uint32))
    return nib, palette[:16].copy(), L


def device_codes(codes: np.ndarray, device) -> torch.Tensor:
    """Host uint8 [N, L] code batch -> device uint8 [N, L], moved 2-bit
    packed and unpacked on the device."""
    with trace.span("upload") as sp:
        w, m, L = pack_codes(codes)
        sp.add("bytes", w.nbytes + m.nbytes)
        return unpack_codes(to_device_words(w, device),
                            to_device_words(m, device), L)


def device_quals(quals: np.ndarray, device) -> torch.Tensor:
    """Host uint8 qual batch -> device, moved 4-bit palette-packed when
    <=16 distinct values, raw otherwise."""
    with trace.span("upload") as sp:
        nib, pal, L = pack_quals(quals)
        pal = np.asarray(pal)
        sp.add("bytes", pal.nbytes + (0 if nib is None else nib.nbytes))
        if nib is None:
            return torch.from_numpy(pal).to(device)
        return unpack_quals(to_device_words(nib, device),
                            torch.from_numpy(pal).to(device), L)


def unpack_quals(nibbles, palette, L: int):
    """Device unpack: -> [N, L] uint8. With `nibbles` None, `palette` is
    the raw qual matrix (the >16-value fallback)."""
    if nibbles is None:
        return palette
    j = torch.arange(L, device=nibbles.device)
    idx = (nibbles[:, j // 8] >> ((j % 8) * 4)) & 15
    return palette[idx].to(torch.uint8)

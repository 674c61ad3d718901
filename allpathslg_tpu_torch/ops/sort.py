"""Multi-word lexicographic sort-by-key (port of allpathslg_tpu/ops/sort.py).

Key words are int64 tensors holding uint32 values (kmer/bits.py). Keys of
one or two words go through ONE stable 64-bit radix sort
(ops/cuda/sort_cuda.py: the Hopper kernel on a CUDA tensor, its plain
PyTorch version on a CPU tensor). Longer keys sort by stable passes over
two-word groups, least significant group first, composing the
permutations; payloads follow by one gather. The reference sorts with
`lax.sort(is_stable=True)`, so equal keys keep their input order here too.
`sort_rows_by_words` sorts each row of [T, R] words on its own the same
way, through the batched row sort (ops/cuda/row_sort_cuda.py).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from allpathslg_tpu_torch.ops.cuda import row_sort_cuda, sort_cuda

_MASK32 = 0xFFFFFFFF


def _pack_key(words):
    """One or two uint32 words -> (int64 key, key bits)."""
    if len(words) == 1:
        return words[0], 32
    return (words[0] << 32) | words[1], 64


def _unpack_key(key, n_words: int) -> List[torch.Tensor]:
    if n_words == 1:
        return [key]
    return [(key >> 32) & _MASK32, key & _MASK32]


def sort_words_perm(key_words: Sequence[torch.Tensor]):
    """(sorted key words, stable permutation int32)."""
    W = len(key_words)
    if W <= 2:
        key, key_bits = _pack_key(list(key_words))
        skey, perm = sort_cuda.radix_sort(key, key_bits)
        return _unpack_key(skey, W), perm
    perm = None
    for hi in range(W, 0, -2):                  # least significant group first
        group = list(key_words[max(hi - 2, 0):hi])
        if perm is not None:
            group = [w.index_select(0, perm) for w in group]
        key, key_bits = _pack_key(group)
        _, p = sort_cuda.radix_sort(key, key_bits)
        perm = p if perm is None else perm.index_select(0, p)
    return [w.index_select(0, perm) for w in key_words], perm


def sort_rows_by_words(key_words: Sequence[torch.Tensor]):
    """Row-wise sort_words_perm: W words int64 [T, R] -> (each row sorted
    lexicographically, the stable permutation within the row int32)."""
    W = len(key_words)
    if W <= 2:
        key, key_bits = _pack_key(list(key_words))
        skey, perm = row_sort_cuda.row_sort(key, key_bits)
        return _unpack_key(skey, W), perm
    perm = None
    for hi in range(W, 0, -2):                  # least significant group first
        group = list(key_words[max(hi - 2, 0):hi])
        if perm is not None:
            at = perm.long()
            group = [w.gather(1, at) for w in group]
        key, key_bits = _pack_key(group)
        # the sort composes its permutation with the one so far
        _, perm = row_sort_cuda.row_sort(key, key_bits, perm)
    at = perm.long()
    return [w.gather(1, at) for w in key_words], perm


def sort_by_words(key_words: Sequence[torch.Tensor],
                  payloads: Sequence[torch.Tensor] = ()):
    """Sort flat arrays lexicographically by uint32 key words, stably.

    Returns (sorted_key_words, sorted_payloads)."""
    skeys, perm = sort_words_perm(key_words)
    return skeys, [p.index_select(0, perm) for p in payloads]


def run_starts(sorted_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool [T]: True at the first element of each run of equal keys."""
    first = torch.zeros_like(sorted_words[0], dtype=torch.bool)
    first[:1] = True
    diff = torch.zeros_like(first)
    for w in sorted_words:
        diff |= w != torch.roll(w, 1)
    return first | diff

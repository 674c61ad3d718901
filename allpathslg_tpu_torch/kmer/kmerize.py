"""K-mer extraction from read batches (port of allpathslg_tpu/kmer/kmerize.py).

Log-doubling shifted ORs build, for every position q of every read, the
packing of bases [q, q+16); k-mer words are strided slices of that array,
and reverse-complement words come from the same array by 2-bit-group
reversal + complement. Words are int64 holding uint32 (kmer/bits.py).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from allpathslg_tpu_torch.dtypes.reads import PAD_CODE
from allpathslg_tpu_torch.kmer import bits


def _pack16_all_positions(codes_masked: torch.Tensor) -> torch.Tensor:
    """codes_masked: int64 [N, L+16] with values 0..3 (invalid already
    zeroed). Returns [N, L+1]: packed bases [q, q+16) big-endian at each q."""
    Lp = codes_masked.shape[1]
    acc = codes_masked                          # bases [q, q+1)
    for s in (1, 2, 4, 8):                      # never exceeds 32 bits
        acc = (acc[:, : Lp - s] << (2 * s)) | acc[:, s:]
        Lp -= s
    return acc


def _window_words(packed: torch.Tensor, K: int, P: int):
    """Forward + reverse-complement window words from one packed array."""
    W = bits.n_words(K)
    lw_mask = bits.last_word_mask(K)
    fwd = []
    for w in range(W):
        word = packed[:, 16 * w: 16 * w + P]
        if w == W - 1:
            word = word & lw_mask
        fwd.append(word)
    rev2c = bits._rev2_word(packed ^ bits.MASK32)
    rev = []
    for w in range(W):
        s = K - 16 * (w + 1)
        if s >= 0:
            word = rev2c[:, s: s + P]
        else:
            r = K - 16 * w  # bases in this (last) word, 1..15
            word = bits._u32(rev2c[:, 0:P] << (32 - 2 * r))
        if w == W - 1:
            word = word & lw_mask
        rev.append(word)
    return fwd, rev


def _packed_and_valid(codes: torch.Tensor, K: int):
    N, L = codes.shape
    P = L - K + 1
    assert P >= 1, f"reads shorter than K={K}"
    invalid = codes >= PAD_CODE
    cm = torch.where(invalid, 0, codes).long()
    packed = _pack16_all_positions(F.pad(cm, (0, 16)))
    # validity: no invalid base in [p, p+K)
    cs = F.pad(torch.cumsum(invalid, 1, dtype=torch.int32), (1, 0))
    valid = (cs[:, K:] - cs[:, :-K]) == 0  # [N, P]
    return packed, valid, P


def kmer_windows_fwd(codes: torch.Tensor, K: int
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Forward-strand (non-canonical) K-mer windows: (fwd_words, valid)."""
    packed, valid, P = _packed_and_valid(codes, K)
    W = bits.n_words(K)
    fwd = []
    for w in range(W):
        word = packed[:, 16 * w: 16 * w + P]
        if w == W - 1:
            word = word & bits.last_word_mask(K)
        fwd.append(word)
    return fwd, valid


def kmer_windows(codes: torch.Tensor, K: int
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """All canonical K-mers of a read batch: (canon_words, valid), W word
    tensors [N, P] (P = L-K+1) and bool [N, P]."""
    packed, valid, P = _packed_and_valid(codes, K)
    fwd, rev = _window_words(packed, K, P)
    use_rc = bits.lex_less(rev, fwd)
    return bits.select_words(use_rc, rev, fwd), valid


def flatten_kmers(canon_words, valid, K: int):
    """[N, P] word arrays -> flat [N*P] with sentinel keys at invalid slots."""
    vmask = valid.reshape(-1)
    flat = [torch.where(vmask, w.reshape(-1), bits.SENTINEL)
            for w in canon_words]
    return flat, vmask

"""Multi-word packed k-mer bit arithmetic (port of allpathslg_tpu/kmer/bits.py).

Same layout as the reference: a k-mer is ``W = ceil(K/16)`` uint32 words,
big-endian base order, left-aligned, so lexicographic word order is base
order and the all-ones sentinel sorts after every canonical key.

Word type: PyTorch has no shift, add or compare on uint32, so every word
here is an int64 tensor holding the uint32 value (0 .. 2**32-1). Order and
equality of int64 then equal the uint32 ones. Every left shift, complement
and multiply is masked back to 32 bits with `_u32`.
"""

from __future__ import annotations

import numpy as np
import torch

BASES_PER_WORD = 16
MASK32 = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF

# Base codes: A=0 C=1 G=2 T=3; anything >=4 is invalid (N / pad).
INVALID_CODE = 4


def _u32(x):
    return x & MASK32


def n_words(K: int) -> int:
    """Number of uint32 words holding a K-mer."""
    return (K + BASES_PER_WORD - 1) // BASES_PER_WORD


def pad_bits(K: int) -> int:
    """Unused low bits in the last word (kmer is left-aligned)."""
    return 32 * n_words(K) - 2 * K


def last_word_mask(K: int) -> int:
    """uint32 mask keeping only the used (top) bits of the last word."""
    r = K - (n_words(K) - 1) * BASES_PER_WORD  # bases in last word, 1..16
    if r == 16:
        return 0xFFFFFFFF
    return (0xFFFFFFFF << (32 - 2 * r)) & 0xFFFFFFFF


def sentinel_words(K: int, shape=(), device=None):
    """All-ones sentinel key (sorts after every canonical key)."""
    return [torch.full(shape, SENTINEL, dtype=torch.int64, device=device)
            for _ in range(n_words(K))]


def is_sentinel(words) -> torch.Tensor:
    m = words[0] == SENTINEL
    for w in words[1:]:
        m = m & (w == SENTINEL)
    return m


# ---------------------------------------------------------------------------
# bit-level helpers
# ---------------------------------------------------------------------------

def _rev2_word(x):
    """Reverse the sixteen 2-bit groups inside each uint32."""
    m2, m4, m8 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    return (x >> 16) | _u32(x << 16)


def _shift_left_words(words, s: int):
    """Left-shift a multi-word bit string by s (0 <= s < 32) bits."""
    if s == 0:
        return list(words)
    W = len(words)
    out = []
    for w in range(W):
        hi = _u32(words[w] << s)
        out.append(hi | (words[w + 1] >> (32 - s)) if w + 1 < W else hi)
    return out


def rc_words(words, K: int):
    """Reverse complement of packed K-mers (vectorized over any shape)."""
    W = n_words(K)
    assert len(words) == W
    comp = [_rev2_word(words[W - 1 - w]) ^ MASK32 for w in range(W)]
    out = _shift_left_words(comp, pad_bits(K))
    out[-1] = out[-1] & last_word_mask(K)
    return out


def lex_less(a, b):
    """Elementwise lexicographic a < b over word lists."""
    lt = a[0] < b[0]
    eq = a[0] == b[0]
    for wa, wb in zip(a[1:], b[1:]):
        lt = lt | (eq & (wa < wb))
        eq = eq & (wa == wb)
    return lt


def lex_eq(a, b):
    eq = a[0] == b[0]
    for wa, wb in zip(a[1:], b[1:]):
        eq = eq & (wa == wb)
    return eq


def select_words(pred, a, b):
    """where(pred, a, b) per word."""
    return [torch.where(pred, wa, wb) for wa, wb in zip(a, b)]


def canonical(words, K: int):
    """(canon_words, is_rc): canonical = min(fwd, rc) lexicographically."""
    rc = rc_words(words, K)
    use_rc = lex_less(rc, words)
    return select_words(use_rc, rc, words), use_rc


def get_base(words, j: int):
    """Base code (0..3) at position j (static) of each packed kmer."""
    w = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    return ((words[w] >> shift) & 3).to(torch.uint8)


def get_base_dyn(words, j):
    """Base code at tensor position j."""
    j = torch.as_tensor(j).long()
    w_idx = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    stacked = torch.stack(words)  # [W, ...]
    word = torch.gather(stacked, 0,
                        w_idx.expand(stacked.shape[1:]).unsqueeze(0))[0]
    return ((word >> shift) & 3).to(torch.uint8)


def put_base_dyn(words, j, base):
    """Replace the base at tensor position j with `base` (tensors broadcast
    with the word shapes). Returns new word list."""
    j = torch.as_tensor(j).long()
    w_idx = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    b = (base.long() & 3) << shift
    clear = (3 << shift) ^ MASK32
    return [torch.where(w_idx == w, (word & clear) | b, word)
            for w, word in enumerate(words)]


def mask_base_dyn(words, j):
    """Zero the 2 bits of the base at tensor position j (for context keys)."""
    j = torch.as_tensor(j).long()
    w_idx = j // BASES_PER_WORD
    clear = (3 << (30 - 2 * (j % BASES_PER_WORD))) ^ MASK32
    return [torch.where(w_idx == w, word & clear, word)
            for w, word in enumerate(words)]


def mask_base(words, j: int):
    """Zero the 2 bits of the base at static position j."""
    w = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    out = list(words)
    out[w] = out[w] & ((3 << shift) ^ MASK32)
    return out


def shift_append(words, base, K: int):
    """Drop the first base, append `base` (0..3) at the end: the de Bruijn
    successor operation. `base` may be an int or a tensor broadcastable to
    the word shapes."""
    out = _shift_left_words(words, 2)
    j = K - 1
    w = j // BASES_PER_WORD
    shift = 30 - 2 * (j % BASES_PER_WORD)
    out[w] = out[w] | ((torch.as_tensor(base).long() & 3) << shift)
    out[-1] = out[-1] & last_word_mask(K)
    return out


def shift_prepend(words, base, K: int):
    """Drop the last base, prepend `base` at the front: de Bruijn predecessor."""
    W = n_words(K)
    out = []
    for w in range(W):  # right shift by 2 over the 32W-bit string
        lo = words[w] >> 2
        out.append(_u32(words[w - 1] << 30) | lo if w > 0 else lo)
    out[0] = out[0] | ((torch.as_tensor(base).long() & 3) << 30)
    out[-1] = out[-1] & last_word_mask(K)
    return out


def _mul_u32(x, c: int):
    """x * c mod 2**32 for x in [0, 2**32): split c in 16-bit halves so no
    int64 product exceeds 2**49 (a full 32 x 32-bit product would wrap)."""
    return _u32(x * (c & 0xFFFF) + (_u32(x * (c >> 16)) << 16))


def hash_words(words, seed: int = 0):
    """Cheap mixing hash of packed kmers -> uint32 (held in int64); equal to
    the reference's uint32 arithmetic, which wraps mod 2**32."""
    h = _u32(0x9E3779B9 + seed)
    for w in words:
        h = _mul_u32(w ^ h, 0x85EBCA6B)
        h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


# ---------------------------------------------------------------------------
# numpy oracles (host-side reference implementations for tests)
# ---------------------------------------------------------------------------

def np_pack(seq_codes, K: int) -> tuple:
    """Pack a 1-D numpy array of base codes (len K) into W python ints."""
    W = n_words(K)
    words = [0] * W
    for j, b in enumerate(seq_codes[:K]):
        w = j // BASES_PER_WORD
        shift = 30 - 2 * (j % BASES_PER_WORD)
        words[w] |= (int(b) & 3) << shift
    return tuple(words)


def np_unpack(words, K: int) -> np.ndarray:
    out = np.empty(K, dtype=np.uint8)
    for j in range(K):
        w = j // BASES_PER_WORD
        shift = 30 - 2 * (j % BASES_PER_WORD)
        out[j] = (int(words[w]) >> shift) & 3
    return out


def np_rc(words, K: int) -> tuple:
    codes = np_unpack(words, K)
    return np_pack((3 - codes)[::-1], K)


def np_canonical(words, K: int) -> tuple:
    rc = np_rc(words, K)
    return min(tuple(words), tuple(rc))

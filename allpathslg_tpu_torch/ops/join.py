"""Exact joins over multi-word keys (port of allpathslg_tpu/ops/join.py).

Two forms, as in the reference:
  * `searchsorted_words`: branchless lower-bound binary search into a
    lexicographically sorted word table (log2(M) x W gathers per query);
  * the hash-bucketed join (`build_hashed` / `lookup_hashed` /
    `HashedTable`): rows sorted by a 32-bit mixed hash with a bucket
    directory; a query scans at most H slots of its bucket on (hash,
    second fingerprint), then verifies the full key words once. The EC
    stages use this one. `shift`, `H` and `bucket_starts` come out
    identical to the reference's for the same table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch.kmer import bits
from allpathslg_tpu_torch.ops import sort as ops_sort

_FP_SEED = 0x51ED270


def _gather_words(table_words, idx):
    return [w[idx] for w in table_words]


def searchsorted_words(table_words: Sequence[torch.Tensor],
                       query_words: Sequence[torch.Tensor],
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower-bound binary search of queries in a lexicographically sorted
    multi-word table: (idx int32 [Q], found bool [Q])."""
    M = table_words[0].shape[0]
    Q = query_words[0].shape[0]
    dev = query_words[0].device
    lo = torch.zeros(Q, dtype=torch.int64, device=dev)
    hi = torch.full((Q,), M, dtype=torch.int64, device=dev)
    for _ in range(max(1, (M + 1).bit_length())):
        mid = (lo + hi) >> 1
        t = _gather_words(table_words, mid.clamp(max=M - 1))
        less = bits.lex_less(t, query_words)  # table[mid] < q
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    at = _gather_words(table_words, lo.clamp(max=M - 1))
    found = (lo < M) & bits.lex_eq(at, query_words)
    return lo.to(torch.int32), found


def lookup_payload(table_words, table_payload, query_words, default):
    """Join: for each query, payload of matching table row (or default)."""
    idx, found = searchsorted_words(table_words, query_words)
    safe = idx.long().clamp(max=table_words[0].shape[0] - 1)
    return torch.where(found, table_payload[safe], default), found


def build_hashed(table_words, payloads=(), buckets_per_row: int = 4):
    """Hash-sort a (possibly sentinel-padded) key table and build the bucket
    directory.

    Returns (hash_fp, words_sorted, payloads_sorted, bucket_starts, shift,
    H): hash_fp stacks the bucket hash and an independent second
    fingerprint (rows [2, M]); shift and H are Python ints. Rows whose
    words are all sentinels are left out of the buckets."""
    table_words = list(table_words)
    sent_mask = bits.is_sentinel(table_words)
    h = bits.hash_words(table_words).clamp(max=0xFFFFFFFE)
    h = torch.where(sent_mask, bits.SENTINEL, h)
    fp = bits.hash_words(table_words, seed=_FP_SEED)
    skeys, spay = ops_sort.sort_by_words(
        [h], [fp] + table_words + list(payloads))
    hs = skeys[0]
    W = len(table_words)
    fps = spay[0]
    ws = spay[1:1 + W]
    ps = spay[1 + W:]
    n_valid = int((~sent_mask).sum())
    nb_bits = max(10, min(26, int(np.ceil(np.log2(
        max(buckets_per_row * max(n_valid, 1), 2))))))
    shift = 32 - nb_bits
    NB = 1 << nb_bits
    bounds = torch.arange(NB, dtype=torch.int64, device=hs.device) << shift
    bucket_starts = torch.cat([
        torch.searchsorted(hs, bounds, side="left").to(torch.int32),
        torch.tensor([n_valid], dtype=torch.int32, device=hs.device)])
    # max bucket occupancy -> scan depth, rounded up to a power of two as
    # the reference rounds it (its static scan depth)
    occ = bucket_starts[1:] - bucket_starts[:-1]
    H = max(1, int(occ.max()))
    H = 1 << (H - 1).bit_length()
    return torch.stack([hs, fps]), ws, ps, bucket_starts, shift, H


def lookup_hashed(hash_fp, bucket_starts, words_sorted, query_words,
                  shift: int, H: int, payload=None, default=0):
    """Exact join against a build_hashed table.

    Returns (found bool [Q], payload-or-default [Q] when payload given,
    else row index or -1)."""
    hash_sorted = hash_fp[0]
    fp_sorted = hash_fp[1]
    M = hash_sorted.shape[0]
    query_words = list(query_words)
    qh = bits.hash_words(query_words).clamp(max=0xFFFFFFFE)
    qfp = bits.hash_words(query_words, seed=_FP_SEED)
    b = qh >> shift
    lo = bucket_starts[b].long()
    hi = bucket_starts[b + 1].long()
    found_at = torch.full(qh.shape, -1, dtype=torch.int64, device=qh.device)
    for k in range(H):
        idx = lo + k
        safe_k = idx.clamp(max=M - 1)
        m = ((idx < hi) & (hash_sorted[safe_k] == qh)
             & (fp_sorted[safe_k] == qfp) & (found_at < 0))
        found_at = torch.where(m, idx, found_at)
    safe = found_at.clamp(0, M - 1)
    exact = found_at >= 0
    for w, q in zip(words_sorted, query_words):
        exact = exact & (w[safe] == q)
    if payload is None:
        return exact, torch.where(exact, safe, -1).to(torch.int32)
    return exact, torch.where(exact, payload[safe], default)


@dataclasses.dataclass
class HashedTable:
    """build_hashed output: tensors plus the Python ints (shift, H)."""
    hash_fp: Any            # int64 (uint32 values) [2, M]
    words: tuple            # W sorted-by-hash word tensors
    payloads: tuple         # payloads, hash-sorted alongside
    bucket_starts: Any      # int32 [NB + 1]
    shift: int
    H: int


def hash_table(table_words, payloads=(), buckets_per_row: int = 4
               ) -> HashedTable:
    """build_hashed packaged as a HashedTable."""
    hs, ws, ps, bs, shift, H = build_hashed(
        list(table_words), payloads=list(payloads),
        buckets_per_row=buckets_per_row)
    return HashedTable(hash_fp=hs, words=tuple(ws), payloads=tuple(ps),
                       bucket_starts=bs, shift=shift, H=H)


def member_hashed(ht: HashedTable, query_words):
    """bool [Q]: query key present in the hashed table."""
    found, _ = lookup_hashed(ht.hash_fp, ht.bucket_starts, list(ht.words),
                             list(query_words), ht.shift, ht.H)
    return found


def payload_hashed(ht: HashedTable, payload_i: int, query_words, default):
    """(payload-or-default [Q], found bool [Q]) from the i-th payload."""
    found, pay = lookup_hashed(ht.hash_fp, ht.bucket_starts, list(ht.words),
                               list(query_words), ht.shift, ht.H,
                               payload=ht.payloads[payload_i],
                               default=default)
    return pay, found

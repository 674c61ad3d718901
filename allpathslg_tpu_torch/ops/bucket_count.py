"""Bucketed k-mer grouping: group equal keys without one global flat sort
(port of allpathslg_tpu/ops/bucket_count.py).

Counting does not need a total order, only all copies of each key adjacent.
So every sort here is a BATCHED ROW SORT (ops/sort.sort_rows_by_words: the
Hopper row sort of csrc/row_sort.cu on a CUDA tensor, its plain PyTorch
version on a CPU tensor), apart from one small flat sort of a sample
(ops/sort, the Hopper radix sort):

  1. reshape the flat keys to [T, R] tiles; sort each row
  2. pick bucket edges from a per-tile strided sample (quantile splitters
     on the leading word)
  3. per tile, locate each bucket's contiguous run (searchsorted along the
     rows) and gather the runs into fixed slabs [T, B, S] (sentinel padded)
  4. transpose to [B, T*S] and row-sort again: now every bucket holds ALL
     copies of its keys, grouped and sorted

Bucket-major order of sorted buckets is globally sorted (edges ascend), so
the output is a sentinel-interleaved sorted sequence: run-length counting
works unchanged.

Overflow safety: slabs hold S = ceil(N/(B*T) * slack) elements per
(tile, bucket); group_keys also returns the largest run it saw.
`count_grouped` retries with a doubled slack, then falls back to the flat
sort (kmer/count.count_sorted); `spectrum_grouped` returns ok = False.

Words are int64 tensors holding uint32 values (kmer/bits.py), the sentinel
the all-ones word. The reference sorts keys only and unstably; a keys-only
sort has one result, so the port's stable sorts give the same arrays.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from allpathslg_tpu_torch.kmer import bits
from allpathslg_tpu_torch.kmer import count as kcount
from allpathslg_tpu_torch.ops import segmented
from allpathslg_tpu_torch.ops import sort as ops_sort

SENT = bits.SENTINEL


def group_keys(words: Sequence[torch.Tensor], tile_rows: int,
               n_buckets: int, slots: int):
    """Group equal multi-word keys adjacently.

    Args:
      words: W int64 word tensors, flat [N] (N % tile_rows == 0 required;
        pad with the all-ones sentinel first).
      tile_rows: R, elements per tile row.
      n_buckets: B bucket count.
      slots: S slab slots per (tile, bucket).

    Returns (grouped_words [B*T*S] with sentinel padding interspersed,
             max_run: int32 scalar — max (tile,bucket) occupancy for
             overflow detection; valid grouping iff max_run <= slots).
    """
    N = words[0].shape[0]
    R = tile_rows
    T = N // R
    B = n_buckets
    S = slots
    dev = words[0].device

    srt, _ = ops_sort.sort_rows_by_words([w.reshape(T, R) for w in words])

    # quantile edges from a strided sample of every sorted tile row (w0)
    P = max(R // 256, B)
    samp = srt[0][:, :: R // P].reshape(-1)
    (samp,), _ = ops_sort.sort_by_words([samp])
    M = samp.shape[0]
    qi = (torch.arange(1, B, dtype=torch.int64, device=dev) * M) // B
    edges = samp[qi]                                   # [B-1] ascending

    # sentinels (all-ones keys: padding + invalid windows) sort to each
    # row's end; bucket spans are clipped to the real-key prefix so
    # sentinels never occupy slab slots
    sent_row = bits.is_sentinel(srt)
    nreal = R - sent_row.sum(dim=1)                    # [T]

    # per-tile bucket boundaries on the leading word
    starts = torch.searchsorted(srt[0], edges.expand(T, B - 1).contiguous(),
                                side="left")
    starts = torch.cat([starts.new_zeros((T, 1)), starts,
                        starts.new_full((T, 1), R)], dim=1)   # [T, B+1]
    starts = torch.minimum(starts, nreal[:, None])
    cnt = starts[:, 1:] - starts[:, :-1]               # [T, B]
    max_run = cnt.max().to(torch.int32)

    # slab gather: idx[t, b, s] = starts[t, b] + s (masked beyond cnt)
    s_iota = torch.arange(S, dtype=torch.int64, device=dev)
    idx = starts[:, :-1, None] + s_iota[None, None, :]         # [T, B, S]
    valid = s_iota[None, None, :] < cnt[:, :, None]
    idx_c = idx.clamp(max=R - 1).reshape(T, B * S)
    out = []
    for w in srt:
        g = w.gather(1, idx_c).reshape(T, B, S)
        g = torch.where(valid, g, SENT)
        # [T, B, S] -> [B, T, S] -> rows per bucket
        out.append(g.transpose(0, 1).reshape(B, T * S))

    final, _ = ops_sort.sort_rows_by_words(out)
    return [f.reshape(-1) for f in final], max_run


def _pad_to(words: List[torch.Tensor], n: int):
    N0 = words[0].shape[0]
    if N0 == n:
        return words
    pad = n - N0
    return [torch.cat([w, w.new_full((pad,), SENT)]) for w in words]


def count_grouped(flat_words: Sequence[torch.Tensor],
                  tile_rows: int = 1 << 17, n_buckets: int = 128,
                  slack: float = 1.5):
    """Drop-in alternative to kmer/count.count_sorted built on group_keys:
    returns (grouped_words, counts_at_starts, starts_mask) with sentinel
    padding interspersed (excluded from counts). Retries with doubled slack
    on slab overflow, then falls back to the flat sort."""
    words = list(flat_words)
    N0 = words[0].shape[0]
    R = tile_rows
    while R > N0:
        R >>= 1
    R = max(R, 1024)
    N = ((N0 + R - 1) // R) * R
    words = _pad_to(words, N)
    T = N // R
    B = min(n_buckets, max(T, 8))
    for _ in range(2):
        S = int(np.ceil(N / (B * T) * slack))
        g, max_run = group_keys(words, R, B, S)
        if int(max_run) <= S:
            starts = ops_sort.run_starts(g)
            counts = segmented.run_lengths(starts)
            counts = torch.where(bits.is_sentinel(g), 0, counts)
            return g, counts, starts
        slack *= 2.0
    # pathological key distribution: fall back to the flat sort
    return kcount.count_sorted(words)


def spectrum_grouped(words: Sequence[torch.Tensor], tile_rows: int,
                     n_buckets: int, slots: int, max_freq: int = 255):
    """Spectrum via bucketed grouping (no flat global sort).

    Returns (spec int32 [max_freq+1], n_unique int32, ok bool) — ok False
    means a (tile, bucket) slab overflowed and the result is INVALID; the
    caller must re-run with larger slots or use the flat path. Padding
    sentinels are excluded from both spec and n_unique.
    """
    g, max_run = group_keys(list(words), tile_rows, n_buckets, slots)
    starts = ops_sort.run_starts(g)
    counts = segmented.run_lengths(starts)
    counts = torch.where(bits.is_sentinel(g), 0, counts)
    spec = kcount.spectrum_from_counts(counts, max_freq)
    n_unique = (counts > 0).sum(dtype=torch.int32)
    return spec, n_unique, max_run <= slots


def grouping_plan(n_rows: int, tile_rows: int = 1 << 17,
                  n_buckets: int = 128, slack: float = 1.5):
    """Static (padded_n, tile_rows, n_buckets, slots) for a flat key count,
    shared by spectrum_grouped callers so shapes coincide."""
    R = tile_rows
    while R > n_rows:
        R >>= 1
    R = max(R, 1024)
    N = ((n_rows + R - 1) // R) * R
    T = N // R
    B = min(n_buckets, max(T, 8))
    S = int(np.ceil(N / (B * T) * slack))
    return N, R, B, S

"""Sort-based k-mer counting and spectra (port of allpathslg_tpu/kmer/count.py).

extract -> canonicalize -> multi-word sort -> run-length count. Invalid
windows carry the all-ones sentinel key, which sorts last and is excluded
by masking. Counting is sort + two scans, so the cost is the sort: on a
CUDA tensor it is the Hopper radix sort (ops/cuda/sort_cuda.py).

A `CountedKmers` is a fixed-size padded table: sorted unique canonical keys
at the front, sentinel padding behind, counts aligned. Batches merge by
concat + re-sort, so large read sets stream through in fixed-size chunks.

Integer widths follow the reference as it runs (64-bit mode off): counts,
quality sums and spectra are int32. Functions that take host (numpy) reads
take the `device` to count on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.ops import segmented
from allpathslg_tpu_torch.ops import sort as ops_sort

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class CountedKmers:
    """Padded sorted unique canonical kmer table with counts."""

    words: List[torch.Tensor]       # W x int64 (uint32 values) [M]
    counts: torch.Tensor            # int32 [M]; 0 on padding
    qsum: Optional[torch.Tensor]    # int32 [M]; summed min-base-qual support
    n_unique: torch.Tensor          # int32 scalar

    @property
    def capacity(self) -> int:
        return self.counts.shape[0]


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _words_to_np(words) -> np.ndarray:
    """Word tensors -> uint32 [W, M] numpy (the reference's host layout)."""
    return np.stack([_np(w) for w in words]).astype(np.uint32)


def window_min_qual(codes, quals, K: int):
    """Min base quality per K-window (ref: src/paths/FindErrorsCore.cc)."""
    q = torch.where(codes >= 4, 255, quals.to(_I32)).to(_I32)
    return q.unfold(1, K, 1).amin(-1)


def count_sorted(flat_words) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """Sort flat canonical keys; return (sorted_words, counts_at_starts,
    starts)."""
    skeys, _ = ops_sort.sort_by_words(list(flat_words))
    starts = ops_sort.run_starts(skeys)
    counts = segmented.run_lengths(starts)
    counts = torch.where(bits.is_sentinel(skeys), 0, counts)
    return skeys, counts, starts


def spectrum_from_counts(counts: torch.Tensor, max_freq: int = 255):
    """Histogram of run counts: spec[f] = # distinct kmers with count f
    (f clipped to max_freq; spec[0] = 0). int32 [max_freq + 1]."""
    c = counts.clamp(0, max_freq).long()
    spec = torch.bincount(c, minlength=max_freq + 1).to(_I32)
    spec[0] = 0
    return spec


def count_reads(codes: torch.Tensor, K: int,
                quals: Optional[torch.Tensor] = None) -> CountedKmers:
    """Canonical K-mer counts of one read batch as a compact padded table.
    With `quals`, also the per-kmer quality support (sum of window-min base
    quals over occurrences)."""
    canon, valid = kmerize.kmer_windows(codes, K)
    flat, vmask = kmerize.flatten_kmers(canon, valid, K)
    if quals is None:
        skeys, counts, starts = count_sorted(flat)
        return compact_table(skeys, counts, starts)
    wq = torch.where(vmask, window_min_qual(codes, quals, K).reshape(-1), 0)
    skeys, spay = ops_sort.sort_by_words(flat, [wq])
    starts = ops_sort.run_starts(skeys)
    counts = segmented.run_lengths(starts)
    counts = torch.where(bits.is_sentinel(skeys), 0, counts)
    qsum = _sum_per_run(spay[0], starts, counts)
    return compact_table(skeys, counts, starts, qsum)


def count_reads_packed(words, nmask, L: int, K: int,
                       qnib=None, qpal=None) -> CountedKmers:
    """count_reads over a 2-bit packed batch (dtypes/packed)."""
    from allpathslg_tpu_torch.dtypes import packed as pk

    codes = pk.unpack_codes(words, nmask, L)
    quals = None if qnib is None and qpal is None \
        else pk.unpack_quals(qnib, qpal, L)
    return count_reads(codes, K, quals)


def _sum_per_run(values, starts, counts):
    """Sum of `values` over each run, placed at run starts (0 elsewhere).
    The prefix sum runs in int64 and the difference is cast to int32: the
    same value as the reference's wrapping int32 prefix sum."""
    del starts  # runs are given by their lengths at the starts
    cs = torch.cumsum(values, 0, dtype=torch.int64)
    T = values.shape[0]
    idx = torch.arange(T, device=values.device)
    last = (idx + counts - 1).clamp(0, T - 1)
    before = torch.where(idx > 0, cs[(idx - 1).clamp(min=0)], 0)
    return torch.where(counts > 0, cs[last] - before, 0).to(_I32)


def compact_table(skeys, counts, starts, qsum=None) -> CountedKmers:
    """Move unique keys to the front via a sentinel-keyed re-sort."""
    del starts
    is_real = counts > 0
    keyed = [torch.where(is_real, w, bits.SENTINEL) for w in skeys]
    pay = [counts] + ([qsum] if qsum is not None else [])
    uwords, upay = ops_sort.sort_by_words(keyed, pay)
    return CountedKmers(words=uwords, counts=upay[0],
                        qsum=upay[1] if qsum is not None else None,
                        n_unique=is_real.sum(dtype=_I32))


def spectrum_reads(codes: torch.Tensor, K: int, max_freq: int = 255):
    """Spectrum + n_unique without building the compact table."""
    canon, valid = kmerize.kmer_windows(codes, K)
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    _, counts, _ = count_sorted(flat)
    return spectrum_from_counts(counts, max_freq), (counts > 0).sum(dtype=_I32)


def spectrum_reads_auto(codes: torch.Tensor, K: int, max_freq: int = 255):
    """Spectrum + n_unique via the TUNED counting engine (tuning.py
    "count_engine"): "bucketed" routes through ops/bucket_count.py (batched
    row sorts; falls back to the flat path on slab overflow), "flat" is
    `spectrum_reads`. Runs on the device of `codes`; the overflow check
    synchronises once."""
    from allpathslg_tpu_torch import tuning

    if tuning.get("count_engine") != "bucketed":
        return spectrum_reads(codes, K, max_freq)
    from allpathslg_tpu_torch.ops import bucket_count

    flat = _kmer_flat(codes, K)
    N, R, B, S = bucket_count.grouping_plan(int(flat[0].shape[0]))
    words = bucket_count._pad_to(flat, N)
    spec, nu, ok = bucket_count.spectrum_grouped(words, R, B, S, max_freq)
    if bool(ok):
        return spec, nu
    return spectrum_reads(codes, K, max_freq)


def _kmer_flat(codes: torch.Tensor, K: int) -> List[torch.Tensor]:
    canon, valid = kmerize.kmer_windows(codes, K)
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    return list(flat)


def recount_table(words, counts, qsum=None) -> CountedKmers:
    """Re-aggregate a (possibly duplicated, unsorted) kmer table: sum counts
    on equal keys and compact."""
    pay = [counts] + ([qsum] if qsum is not None else [])
    skeys, spay = ops_sort.sort_by_words(list(words), pay)
    starts = ops_sort.run_starts(skeys)
    rl = segmented.run_lengths(starts)  # runs of table rows, not kmer counts
    real = ~bits.is_sentinel(skeys) & (spay[0] > 0)
    csum = torch.where(real, _sum_per_run(spay[0], starts, rl), 0)
    qs = (torch.where(real, _sum_per_run(spay[1], starts, rl), 0)
          if qsum is not None else None)
    return compact_table(skeys, csum, starts, qs)


def _pad_batch_np(cb, qb, batch_size: int):
    """Pad a tail batch to the fixed batch size (all-N reads, zero quals)."""
    n = cb.shape[0]
    if n == batch_size:
        return cb, qb
    pad = batch_size - n
    cb = np.concatenate([cb, np.full((pad, cb.shape[1]), 4, cb.dtype)])
    if qb is not None:
        qb = np.concatenate([qb, np.zeros((pad, qb.shape[1]), qb.dtype)])
    return cb, qb


def count_reads_streaming(codes: np.ndarray, K: int,
                          quals: np.ndarray = None,
                          batch_size: int = 65536,
                          device_budget_bytes: int = 3 << 30,
                          min_count: int = 0,
                          min_qsum: int = 0,
                          spectrum_max_freq: int = None,
                          merge_group: int = 8,
                          acc_budget_bytes: int = 2 << 30, *,
                          device):
    """Host driver for large read sets: count per fixed-size batch on
    `device`, re-aggregate (ref: KmerParcelsBuilder multi-pass parcels).

    Three regimes by size, as in the reference:
      * fits `device_budget_bytes` -> all batch tables stay on the device,
        one concat + recount at the end;
      * larger -> incremental device merge every `merge_group` batches into
        an accumulator re-quantized to the next power of two;
      * accumulator beyond `acc_budget_bytes` -> spill to host and finish
        with the range-partitioned multi-pass merge.

    min_count/min_qsum filter the returned table in every regime.
    spectrum_max_freq: also return the spectrum of ALL counts (pre-filter):
    (CountedKmers, spectrum np.ndarray).
    """
    n = codes.shape[0]
    L = codes.shape[1]
    W = bits.n_words(K)
    n_batches = (n + batch_size - 1) // batch_size
    rows_per_batch = batch_size * max(L - K + 1, 1)
    n_arrays = W + 1 + (1 if quals is not None else 0)
    total_bytes = n_batches * rows_per_batch * n_arrays * 4
    if total_bytes <= device_budget_bytes:
        ck = _count_reads_device_resident(codes, K, quals, batch_size,
                                          device=device)
        if spectrum_max_freq is not None:
            spec = _np(spectrum_from_counts(ck.counts, spectrum_max_freq))
            return _filter_counted(ck, min_count, min_qsum), spec
        return _filter_counted(ck, min_count, min_qsum)

    def parts():
        from allpathslg_tpu_torch.dtypes import packed as pk

        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            cb, qb = _pad_batch_np(
                np.asarray(codes[s:e]),
                None if quals is None else np.asarray(quals[s:e]), batch_size)
            # 2-bit packed transfer (see count_reads_packed)
            w, m, Lb = pk.pack_codes(cb)
            w = pk.to_device_words(w, device)
            m = pk.to_device_words(m, device)
            if qb is None:
                yield count_reads_packed(w, m, Lb, K)
            else:
                qn, qp, _ = pk.pack_quals(qb)
                yield count_reads_packed(
                    w, m, Lb, K,
                    None if qn is None else pk.to_device_words(qn, device),
                    torch.from_numpy(qp).to(device))

    return count_parts_streaming(parts(), min_count, min_qsum,
                                 spectrum_max_freq=spectrum_max_freq,
                                 merge_group=merge_group,
                                 acc_budget_bytes=acc_budget_bytes)


def _spill(ck: CountedKmers):
    t = trim_to_host(ck)
    return (np.stack([_np(w) for w in t.words]), _np(t.counts),
            None if t.qsum is None else _np(t.qsum))


def count_parts_streaming(parts_iter, min_count: int = 0, min_qsum: int = 0,
                          spectrum_max_freq: int = None,
                          merge_group: int = 8,
                          acc_budget_bytes: int = 2 << 30):
    """Fold an iterator of per-batch CountedKmers into one table (the
    incremental device-merge + host-spill machinery of
    count_reads_streaming), on the device of the parts."""
    sc = StreamingCounter(merge_group, acc_budget_bytes)
    for part in parts_iter:
        sc.add(part)
    return sc.finish(min_count, min_qsum, spectrum_max_freq=spectrum_max_freq)


def count_resident_streaming(db, K: int, use_quals: bool = True,
                             min_count: int = 0, min_qsum: int = 0,
                             spectrum_max_freq: int = None,
                             merge_group: int = 8,
                             acc_budget_bytes: int = 2 << 30):
    """count_reads_streaming over a DeviceBatches cache: every batch is
    already resident on its device (dtypes/devcache)."""
    W = bits.n_words(K)
    hq = use_quals and db.qpal and db.qpal[0] is not None
    n_arrays = W + 1 + (1 if hq else 0)

    def parts():
        for i in range(db.n_batches):
            if hq:
                yield count_reads_packed(db.words[i], db.nmask[i], db.L, K,
                                         db.qnib[i], db.qpal[i])
            else:
                yield count_reads_packed(db.words[i], db.nmask[i], db.L, K)

    return count_parts_streaming(parts(), min_count, min_qsum,
                                 spectrum_max_freq=spectrum_max_freq,
                                 merge_group=merge_group,
                                 acc_budget_bytes=acc_budget_bytes)


def _quantize_capacity(n: int, floor: int = 1 << 20) -> int:
    """Next power of two >= n (>= floor): O(log) distinct merge shapes."""
    return max(floor, 1 << max(int(n) - 1, 1).bit_length())


class StreamingCounter:
    """Device-resident streaming aggregator of CountedKmers parts (any word
    width: kmer keys, (context, base) stack keys, ...).

    add() folds every `merge_group` tables into a quantized accumulator on
    the parts' device (one scalar sync per fold); beyond `acc_budget_bytes`
    the accumulator spills to host and finish() completes with the
    range-partitioned multi-pass merge (ref: KmerParcelsBuilder multi-pass).
    The reference's count_parts_streaming repeats this fold inline; here it
    drives this class."""

    def __init__(self, merge_group: int = 8,
                 acc_budget_bytes: int = 2 << 30):
        self.merge_group = merge_group
        self.acc_budget = acc_budget_bytes
        self.acc: Optional[CountedKmers] = None
        self.group: List[CountedKmers] = []
        self.spilled = []
        self.device = None

    def add(self, part: CountedKmers):
        self.device = part.counts.device
        self.group.append(part)
        if len(self.group) >= self.merge_group:
            self._fold()

    def _fold(self):
        if not self.group:
            return
        tabs = ([self.acc] if self.acc is not None else []) + self.group
        self.group = []
        merged = _concat_recount(tabs)
        cap = _quantize_capacity(int(merged.n_unique))
        self.acc = _slice_table(merged, cap)
        n_arrays = (len(self.acc.words) + 1
                    + (1 if self.acc.qsum is not None else 0))
        if cap * n_arrays * 4 > self.acc_budget:
            self.spilled.append(_spill(self.acc))
            self.acc = None

    def finish(self, min_count: int = 0, min_qsum: int = 0,
               spectrum_max_freq: int = None):
        """The merged table, filtered; with spectrum_max_freq also the
        spectrum of all counts: (CountedKmers, np.ndarray)."""
        self._fold()
        if self.spilled:
            if self.acc is not None:
                self.spilled.append(_spill(self.acc))
                self.acc = None
            return _merge_host_parts(self.spilled, min_count, min_qsum,
                                     spectrum_max_freq=spectrum_max_freq,
                                     device=self.device)
        if self.acc is None:
            raise ValueError("finish() before any add()")
        out = _filter_counted(self.acc, min_count, min_qsum)
        if spectrum_max_freq is not None:
            return out, _np(spectrum_from_counts(self.acc.counts,
                                                 spectrum_max_freq))
        return out


def _concat_recount(tabs: List[CountedKmers]) -> CountedKmers:
    """Concatenate compact tables and re-aggregate on device."""
    W = len(tabs[0].words)
    words = [torch.cat([t.words[w] for t in tabs]) for w in range(W)]
    counts = torch.cat([t.counts for t in tabs])
    have_q = all(t.qsum is not None for t in tabs)
    qsum = torch.cat([t.qsum for t in tabs]) if have_q else None
    return recount_table(words, counts, qsum)


def _slice_table(ck: CountedKmers, cap: int) -> CountedKmers:
    """Slice of the compact front (cap >= n_unique required)."""
    return CountedKmers(words=[w[:cap] for w in ck.words],
                        counts=ck.counts[:cap],
                        qsum=None if ck.qsum is None else ck.qsum[:cap],
                        n_unique=ck.n_unique)


def merge_tables(tabs: List[CountedKmers]) -> CountedKmers:
    """Merge finished tables on device: concat + recount + compact front
    slice; duplicate keys across tabs sum counts/qsums."""
    merged = _concat_recount(tabs)
    return _slice_table(merged, _quantize_capacity(int(merged.n_unique)))


def _filter_counted(ck: CountedKmers, min_count: int, min_qsum: int
                    ) -> CountedKmers:
    if min_count <= 1 and min_qsum <= 0:
        return ck
    keep = ck.counts >= max(min_count, 1)
    if ck.qsum is not None and min_qsum > 0:
        keep = keep & (ck.qsum >= min_qsum)
    return compact_table([torch.where(keep, w, bits.SENTINEL)
                          for w in ck.words],
                         torch.where(keep, ck.counts, 0), None,
                         torch.where(keep, ck.qsum, 0)
                         if ck.qsum is not None else None)


def _to_table_tensors(words_np, counts_np, qsum_np, device):
    return ([torch.from_numpy(np.asarray(w, np.int64)).to(device)
             for w in words_np],
            torch.from_numpy(np.asarray(counts_np, np.int32)).to(device),
            None if qsum_np is None else
            torch.from_numpy(np.asarray(qsum_np, np.int32)).to(device))


def _merge_host_parts(parts, min_count: int, min_qsum: int,
                      rows_budget_bytes: int = 6 << 30,
                      spectrum_max_freq: int = None, *, device):
    """Merge sorted per-batch host tables via key-range partitioned device
    recounts (exact per-kmer totals: a kmer's copies share its w0 range)."""
    W = parts[0][0].shape[0]
    have_q = parts[0][2] is not None
    n_arrays = W + 1 + (1 if have_q else 0)
    total = sum(p[1].shape[0] for p in parts)
    rows_per_pass = max(rows_budget_bytes // (n_arrays * 4 * 3), 1 << 20)
    n_pass = max(1, int(np.ceil(total / rows_per_pass)))
    spec_acc = (np.zeros(spectrum_max_freq + 1, np.int64)
                if spectrum_max_freq is not None else None)

    def run_one(words_np, counts_np, qsum_np):
        T = counts_np.shape[0]
        bucket = 1 << 20
        pad = ((T + bucket - 1) // bucket) * bucket - T
        if pad:
            words_np = [np.concatenate([w, np.full(pad, bits.SENTINEL, w.dtype)])
                        for w in words_np]
            counts_np = np.concatenate([counts_np,
                                        np.zeros(pad, counts_np.dtype)])
            if qsum_np is not None:
                qsum_np = np.concatenate([qsum_np,
                                          np.zeros(pad, qsum_np.dtype)])
        ck = recount_table(*_to_table_tensors(words_np, counts_np, qsum_np,
                                              device))
        if spec_acc is not None:
            spec_acc[:] += _np(spectrum_from_counts(ck.counts,
                                                    spectrum_max_freq))
        return _filter_counted(ck, min_count, min_qsum)

    def finish(ck):
        if spec_acc is not None:
            return ck, spec_acc.astype(np.int64)
        return ck

    if n_pass == 1:
        words_np = [np.concatenate([p[0][w] for p in parts])
                    for w in range(W)]
        counts_np = np.concatenate([p[1] for p in parts])
        qsum_np = np.concatenate([p[2] for p in parts]) if have_q else None
        if len(parts) == 1 and min_count <= 1 and min_qsum <= 0:
            words, counts, qsum = _to_table_tensors(words_np, counts_np,
                                                    qsum_np, device)
            ck = CountedKmers(words=words, counts=counts, qsum=qsum,
                              n_unique=torch.tensor(counts_np.shape[0],
                                                    dtype=_I32, device=device))
            if spec_acc is not None:
                spec_acc[:] += _np(spectrum_from_counts(ck.counts,
                                                        spectrum_max_freq))
            return finish(ck)
        return finish(run_one(words_np, counts_np, qsum_np))

    # range boundaries from a w0 sample (canonical-form skew safe)
    samp = np.concatenate([p[0][0][::997] for p in parts])
    samp.sort()
    qs = np.linspace(0, len(samp), n_pass + 1)[1:-1].astype(np.int64)
    bounds = samp[np.minimum(qs, len(samp) - 1)] if len(samp) else \
        np.zeros(0, np.int64)
    bounds = np.unique(bounds)
    edges = [0] + list(bounds) + [None]

    merged = []
    for pi in range(len(edges) - 1):
        lo, hi = edges[pi], edges[pi + 1]
        ws = [[] for _ in range(W)]
        cs, qs_ = [], []
        for p in parts:
            w0 = p[0][0]
            a = np.searchsorted(w0, lo, side="left")
            b = np.searchsorted(w0, hi, side="left") if hi is not None \
                else len(w0)
            if b <= a:
                continue
            for w in range(W):
                ws[w].append(p[0][w][a:b])
            cs.append(p[1][a:b])
            if have_q:
                qs_.append(p[2][a:b])
        if not cs:
            continue
        ck = trim_to_host(run_one([np.concatenate(x) for x in ws],
                                  np.concatenate(cs),
                                  np.concatenate(qs_) if have_q else None))
        merged.append((np.stack([_np(w) for w in ck.words]), _np(ck.counts),
                       None if ck.qsum is None else _np(ck.qsum)))
    # parts cover disjoint increasing key ranges -> concatenation is the
    # globally sorted merged table
    words, counts, qsum = _to_table_tensors(
        [np.concatenate([m[0][w] for m in merged]) for w in range(W)],
        np.concatenate([m[1] for m in merged]),
        np.concatenate([m[2] for m in merged]) if have_q else None, device)
    return finish(CountedKmers(words=words, counts=counts, qsum=qsum,
                               n_unique=torch.tensor(counts.shape[0],
                                                     dtype=_I32,
                                                     device=device)))


def _count_reads_device_resident(codes, K: int, quals, batch_size: int, *,
                                 device) -> CountedKmers:
    """All per-batch padded tables stay on the device; one concat + recount
    at the end (padded to a multiple of 2**20 rows, as the reference)."""
    n = codes.shape[0]
    parts = []
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        cb, qb = _pad_batch_np(
            np.asarray(codes[s:e]),
            None if quals is None else np.asarray(quals[s:e]), batch_size)
        parts.append(count_reads(
            torch.from_numpy(np.array(cb)).to(device), K,
            None if qb is None else torch.from_numpy(np.array(qb)).to(device)))
    if len(parts) == 1:
        return parts[0]
    W = len(parts[0].words)
    have_q = parts[0].qsum is not None
    T = sum(p.counts.shape[0] for p in parts)
    bucket = 1 << 20
    padn = ((T + bucket - 1) // bucket) * bucket - T
    words = [torch.cat([p.words[w] for p in parts]
                       + [torch.full((padn,), bits.SENTINEL,
                                     dtype=torch.int64, device=device)])
             for w in range(W)]
    counts = torch.cat([p.counts for p in parts]
                       + [torch.zeros(padn, dtype=_I32, device=device)])
    qsum = None
    if have_q:
        qsum = torch.cat([p.qsum for p in parts]
                         + [torch.zeros(padn, dtype=_I32, device=device)])
    return recount_table(words, counts, qsum)


def pad_table_quantized(ck: CountedKmers, floor: int = 1 << 20
                        ) -> CountedKmers:
    """Pad a compact table to the next power-of-two capacity (sentinel
    keys, zero counts), as the reference does for compile stability: the
    padded capacity reaches the hashed table's layout, so it is kept."""
    n = ck.counts.shape[0]
    cap = _quantize_capacity(n, floor)
    if cap == n:
        return ck
    pad = cap - n
    dev = ck.counts.device
    return CountedKmers(
        words=[torch.cat([w, torch.full((pad,), bits.SENTINEL,
                                        dtype=w.dtype, device=dev)])
               for w in ck.words],
        counts=torch.cat([ck.counts, ck.counts.new_zeros(pad)]),
        qsum=None if ck.qsum is None else
        torch.cat([ck.qsum, ck.qsum.new_zeros(pad)]),
        n_unique=ck.n_unique)


def trim_to_host(ck: CountedKmers) -> CountedKmers:
    """Slice the padded table down to its true size."""
    n = int(ck.n_unique)
    return CountedKmers(words=[w[:n] for w in ck.words],
                        counts=ck.counts[:n],
                        qsum=None if ck.qsum is None else ck.qsum[:n],
                        n_unique=ck.n_unique)


def spectrum(ck: CountedKmers, max_freq: int = 255) -> torch.Tensor:
    """Spectrum from a compact table (ref: KmerSpectra)."""
    return spectrum_from_counts(ck.counts, max_freq)

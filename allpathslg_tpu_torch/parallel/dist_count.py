"""Hash-sharded distributed k-mer counting (port of
allpathslg_tpu/parallel/dist_count.py).

Read batches are data-parallel across the mesh: every shard kmerizes its
rows, routes each canonical kmer to its owner shard `hash(kmer) % n`
through a fixed-capacity all_to_all, and the owners sort and count their
partition (ref: src/kmers/kmer_parcels/KmerParcelsBuilder.cc hash
parcels). Spectra merge with psum. Every sort (the routing sort by owner,
the owners' sort and compaction, sample_sort's local sorts) goes through
ops/sort, the Hopper radix sort on a CUDA device.

Fixed-shape routing: per-destination capacity buckets padded with the
sentinel key (payloads with 0); kmers past a bucket's capacity are counted
in `dropped`. The streaming counters merge the per-shard tables on the
host through kmer/count's `_merge_host_parts`, so their tables equal the
1-device path's byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.kmer import count as kcount
from allpathslg_tpu_torch.ops import segmented
from allpathslg_tpu_torch.ops import sort as ops_sort
from allpathslg_tpu_torch.parallel import mesh as pmesh

SENT = bits.SENTINEL
_I32 = torch.int32


def _route_local(flat_words, vmask, n_shards: int, capacity: int,
                 extra=()):
    """Bucket local kmers by owner shard into [n_shards * capacity] slots.

    `extra`: payload arrays routed beside the key words (the window-min
    quality); their buffers pad with 0 rather than the sentinel."""
    h = bits.hash_words(flat_words)
    owner = torch.where(vmask, h % n_shards, n_shards)  # invalid: past the end
    sowner, spay = ops_sort.sort_by_words([owner],
                                          list(flat_words) + list(extra))
    sowner = sowner[0]
    rank = segmented.position_in_run(ops_sort.run_starts([sowner]))
    real = sowner < n_shards
    ok = (rank < capacity) & real
    slot = (sowner * capacity + rank)[ok]
    nw = len(flat_words)
    buf = []
    for i, w in enumerate(spay):
        b = torch.full((n_shards * capacity,), SENT if i < nw else 0,
                       dtype=torch.int64, device=w.device)
        b[slot] = w[ok].long()
        buf.append(b)
    return buf, ((~ok) & real).sum(dtype=_I32)


def _capacity(per_shard: int, n_shards: int, capacity_factor: float) -> int:
    """Rows a (source, owner) bucket holds, rounded up to 8."""
    cap = int(capacity_factor * per_shard / n_shards) + 16
    return -(-cap // 8) * 8


def _kmers(codes_blk, K: int):
    canon, valid = kmerize.kmer_windows(codes_blk, K)
    return kmerize.flatten_kmers(canon, valid, K)


def _exchange(mesh: pmesh.Mesh, bufs):
    """bufs[s]: shard s's routed arrays -> recv[s]: the arrays shard s owns,
    blocks in source-shard order (one all_to_all an array)."""
    cols = [pmesh.all_to_all(mesh, [b[i] for b in bufs])
            for i in range(len(bufs[0]))]
    return [[c[s] for c in cols] for s in range(mesh.n_local)]


def distributed_spectrum(mesh: pmesh.Mesh, codes, K: int,
                         capacity_factor: float = 2.0, max_freq: int = 255):
    """Count kmers of `codes` (uint8 [N, L], N divisible by the mesh size;
    a global array or the local shards' blocks) with the kmer table
    sharded by hash across `mesh`.

    Returns (spectrum int32 [max_freq + 1], dropped int32 scalar,
    table_words, table_counts, n_unique_per_shard int32 [n_local]): the
    table arrays are this process's rows of the global [n * n * capacity]
    arrays (all of them in one process), on mesh.home; rows of shard s hold
    only kmers with hash % n == s."""
    blocks = pmesh.local_blocks(mesh, codes)
    n = mesh.size
    rows, L = blocks[0].shape
    capacity = _capacity(rows * (L - K + 1), n, capacity_factor)
    bufs, dropped = [], []
    for blk in blocks:
        flat, vmask = _kmers(blk, K)
        buf, d = _route_local(flat, vmask, n, capacity)
        bufs.append(buf)
        dropped.append(d)
    specs, tables = [], []
    for recv in _exchange(mesh, bufs):
        skeys, counts, starts = kcount.count_sorted(recv)
        tables.append(kcount.compact_table(skeys, counts, starts))
        specs.append(kcount.spectrum_from_counts(counts, max_freq))
    W = len(tables[0].words)
    return (pmesh.psum(mesh, specs), pmesh.psum(mesh, dropped),
            [pmesh.concat_local(mesh, [t.words[w] for t in tables])
             for w in range(W)],
            pmesh.concat_local(mesh, [t.counts for t in tables]),
            torch.stack([t.n_unique.to(mesh.home) for t in tables]))


def _count_step(mesh: pmesh.Mesh, code_blocks, qual_blocks, K: int,
                capacity: int, with_quals: bool):
    """Kmerize each local shard's reads, hash-route kmers (and window-min
    quals) to their owner shards, sort and count each owned partition.
    Returns (a CountedKmers a local shard, dropped over the mesh)."""
    n = mesh.size
    bufs, dropped = [], []
    for codes_blk, quals_blk in zip(code_blocks, qual_blocks):
        flat, vmask = _kmers(codes_blk, K)
        extra = []
        if with_quals:
            wq = kcount.window_min_qual(codes_blk, quals_blk, K)
            extra = [torch.where(vmask, wq.reshape(-1), 0)]
        buf, d = _route_local(flat, vmask, n, capacity, extra=extra)
        bufs.append(buf)
        dropped.append(d)
    tables = []
    for recv in _exchange(mesh, bufs):
        if with_quals:
            W = len(recv) - 1
            skeys, spay = ops_sort.sort_by_words(recv[:W],
                                                 [recv[W].to(_I32)])
            starts = ops_sort.run_starts(skeys)
            counts = segmented.run_lengths(starts)
            counts = torch.where(bits.is_sentinel(skeys), 0, counts)
            qsum = kcount._sum_per_run(spay[0], starts, counts)
            tables.append(kcount.compact_table(skeys, counts, starts, qsum))
        else:
            skeys, counts, starts = kcount.count_sorted(recv)
            tables.append(kcount.compact_table(skeys, counts, starts))
    return tables, int(pmesh.psum(mesh, dropped))


def _u32_np(w: torch.Tensor) -> np.ndarray:
    """Word tensor (int64 holding uint32) -> uint32 numpy, moved as 4-byte
    values."""
    return w.to(_I32).cpu().numpy().view(np.uint32)


def _host_parts(tables, with_quals: bool) -> list:
    """Each shard's unique rows as a host part (words uint32 [W, m], counts,
    qsum), as _merge_host_parts takes them; empty shards are skipped."""
    parts = []
    for t in tables:
        m = int(t.n_unique)
        if m == 0:
            continue
        parts.append((np.stack([_u32_np(w[:m]) for w in t.words]),
                      t.counts[:m].cpu().numpy(),
                      t.qsum[:m].cpu().numpy() if with_quals else None))
    return parts


def _ici_bytes(n_shards: int, capacity: int, K: int, with_quals: bool) -> int:
    """Bytes an all_to_all batch moves off a shard, the reference's byte
    model: the fixed routing buffers, n_shards * capacity rows of (key
    words + optional qual) x 4 B, of which (n - 1) / n leaves the shard.
    The port's buffers hold int64 words, so they move twice these bytes."""
    n_words_total = bits.n_words(K) + (1 if with_quals else 0)
    return n_shards * capacity * n_words_total * 4 * (n_shards - 1) \
        // n_shards


def _finish(mesh: pmesh.Mesh, parts, K: int, with_quals: bool,
            min_count: int, min_qsum: int, spectrum_max_freq):
    if not parts:
        W = bits.n_words(K)
        empty = kcount.CountedKmers(
            words=[torch.zeros(0, dtype=torch.int64, device=mesh.home)] * W,
            counts=torch.zeros(0, dtype=_I32, device=mesh.home),
            qsum=(torch.zeros(0, dtype=_I32, device=mesh.home)
                  if with_quals else None),
            n_unique=torch.tensor(0, dtype=_I32, device=mesh.home))
        if spectrum_max_freq is not None:
            return empty, np.zeros(spectrum_max_freq + 1, np.int64)
        return empty
    return kcount._merge_host_parts(parts, min_count, min_qsum,
                                    spectrum_max_freq=spectrum_max_freq,
                                    device=mesh.home)


def count_reads_streaming_dist(mesh: pmesh.Mesh, codes, K: int, quals=None,
                               batch_size: int = 65536,
                               min_count: int = 0, min_qsum: int = 0,
                               spectrum_max_freq: int = None,
                               capacity_factor: float = 3.0):
    """Mesh-distributed drop-in for kmer.count.count_reads_streaming.

    Each host batch is data-parallel across the mesh; kmers hash-route to
    owner shards and owners sort and count. Per-shard per-batch compact
    tables come to the host and merge through the same range-partitioned
    merge as the 1-device path, so the final table (and spectrum) equals a
    1-device run over the same reads byte for byte."""
    n = codes.shape[0]
    L = codes.shape[1]
    nsh = mesh.size
    bs = max(batch_size // nsh, 1) * nsh          # divisible by the mesh size
    capacity = _capacity((bs // nsh) * (L - K + 1), nsh, capacity_factor)
    with_quals = quals is not None
    parts = []
    for s in range(0, n, bs):
        e = min(s + bs, n)
        cb, qb = kcount._pad_batch_np(
            np.asarray(codes[s:e]),
            np.asarray(quals[s:e]) if with_quals else None, bs)
        code_blocks = pmesh.sharded(mesh, cb)
        qual_blocks = (pmesh.sharded(mesh, qb) if with_quals
                       else [None] * mesh.n_local)
        tables, dropped = _count_step(mesh, code_blocks, qual_blocks, K,
                                      capacity, with_quals)
        if dropped:
            raise RuntimeError(
                f"distributed count capacity overflow (batch {s}): raise "
                f"capacity_factor above {capacity_factor}")
        parts.extend(_host_parts(tables, with_quals))
    n_batches = (n + bs - 1) // bs
    count_reads_streaming_dist.last_ici_bytes = (
        _ici_bytes(nsh, capacity, K, with_quals) * n_batches)
    return _finish(mesh, parts, K, with_quals, min_count, min_qsum,
                   spectrum_max_freq)


def count_resident_streaming_dist(mesh: pmesh.Mesh, db, K: int,
                                  min_count: int = 0, min_qsum: int = 0,
                                  spectrum_max_freq: int = None,
                                  capacity_factor: float = 3.0):
    """Mesh-distributed count over a DeviceBatches resident cache: each
    resident packed batch's rows split into mesh.size contiguous blocks,
    one a shard, unpacked on the shard; the quality palette is replicated
    ('palette' mode) or the raw quality matrix sharded ('raw' mode). No read
    crosses to the host; per-shard compact tables merge through the same
    host merge as every other path, so tables equal the 1-device run's."""
    nsh = mesh.size
    if db.batch % nsh:
        raise ValueError(f"batch_reads={db.batch} not divisible by "
                         f"mesh size {nsh}")
    L = db.L
    capacity = _capacity((db.batch // nsh) * (L - K + 1), nsh,
                         capacity_factor)
    have_q = bool(db.qpal) and db.qpal[0] is not None
    qual_mode = ("none" if not have_q
                 else "palette" if db.qnib[0] is not None else "raw")
    with_quals = qual_mode != "none"
    from allpathslg_tpu_torch.dtypes import packed as pk

    parts = []
    for i in range(db.n_batches):
        code_blocks = [pk.unpack_codes(w, m, L) for w, m in zip(
            pmesh.sharded(mesh, db.words[i]), pmesh.sharded(mesh, db.nmask[i]))]
        if qual_mode == "palette":
            qual_blocks = [pk.unpack_quals(q, p, L) for q, p in zip(
                pmesh.sharded(mesh, db.qnib[i]),
                pmesh.replicated(mesh, db.qpal[i]))]
        elif qual_mode == "raw":
            qual_blocks = pmesh.sharded(mesh, db.qpal[i])
        else:
            qual_blocks = [None] * mesh.n_local
        tables, dropped = _count_step(mesh, code_blocks, qual_blocks, K,
                                      capacity, with_quals)
        if dropped:
            raise RuntimeError(
                f"resident distributed count capacity overflow (batch {i}):"
                f" raise capacity_factor above {capacity_factor}")
        parts.extend(_host_parts(tables, with_quals))
    count_resident_streaming_dist.last_ici_bytes = (
        _ici_bytes(nsh, capacity, K, with_quals) * db.n_batches)
    return _finish(mesh, parts, K, with_quals, min_count, min_qsum,
                   spectrum_max_freq)


def table_via_sample_sort(mesh: pmesh.Mesh, codes, K: int,
                          batch_size: int = 65536, min_count: int = 0):
    """K-mer table build through the distributed sample sort (ref:
    ParallelSort, the K=96 path): every shard kmerizes its rows, the
    canonical kmer records sample-sort across the mesh, and the globally
    sorted shards concatenate into one run-length counted table, equal to
    the 1-device table."""
    from allpathslg_tpu_torch.parallel.sample_sort import sample_sort_blocks

    n = codes.shape[0]
    L = codes.shape[1]
    nsh = mesh.size
    bs = max(batch_size // nsh, 1) * nsh
    parts = []
    for s in range(0, n, bs):
        e = min(s + bs, n)
        cb, _ = kcount._pad_batch_np(np.asarray(codes[s:e]), None, bs)
        flat = [_kmers(blk, K)[0] for blk in pmesh.sharded(mesh, cb)]
        sw, _, n_real, n_drop = sample_sort_blocks(
            mesh, flat, [[] for _ in flat])
        if n_drop:
            raise RuntimeError("sample_sort capacity overflow")
        for ws, m in zip(sw, n_real):
            if m:
                parts.append((np.stack([_u32_np(w[:m]) for w in ws]),
                              np.ones(m, np.int32), None))
    if not parts:
        return kcount.CountedKmers(
            words=[torch.zeros(0, dtype=torch.int64, device=mesh.home)]
            * bits.n_words(K),
            counts=torch.zeros(0, dtype=_I32, device=mesh.home), qsum=None,
            n_unique=torch.tensor(0, dtype=_I32, device=mesh.home))
    return kcount._merge_host_parts(parts, min_count, 0, device=mesh.home)

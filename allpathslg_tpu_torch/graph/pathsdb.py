"""Read paths in unipath coordinates + the paths database (port of
allpathslg_tpu/graph/pathsdb.py).

Behavior contract (ref: src/paths/KmerPath.{h,cc}, src/paths/ReadPaths.cc,
src/paths/KmerPathDatabase.cc and CommonPather): every read is
re-expressed as the sequence of oriented unipaths it traverses, with
entry/exit window offsets; the pathsdb is the CSR inverse (unipath ->
placements of reads on it).

The per-window join (canonical K-mer -> unipath/pos/orient) runs on the
device through the port's hashed join (ops/join), one read batch at a
time; run compression to ragged paths is the reference's host numpy pass,
copied as it is, as are the edge helpers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch.dtypes import packed as pk
from allpathslg_tpu_torch.kmer import kmerize
from allpathslg_tpu_torch.ops import join


@dataclasses.dataclass
class KmerPlacement:
    """kmer table row -> (unipath, offset, orientation) map.

    table: W sorted canonical kmer word tensors (int64 holding uint32 [M],
    on the device that built them). urc[i] True = canonical form of row i
    appears reverse-complemented in its unipath.
    """
    K: int
    table: List[torch.Tensor]
    uid: np.ndarray   # int32 [M]
    upos: np.ndarray  # int32 [M]
    urc: np.ndarray   # bool  [M]


@dataclasses.dataclass
class ReadPaths:
    """Ragged per-read unipath traversal (flat + offsets).

    Entry i of read r (rows offsets[r]:offsets[r+1]):
      uid[i]    unipath id
      fwd[i]    True = read traverses the unipath in its forward direction
      enter[i]  first read-window index of the run
      leave[i]  last read-window index of the run (inclusive)
      pos[i]    unipath kmer-offset at the `enter` window (along unipath fwd)
    """
    offsets: np.ndarray  # int64 [n_reads + 1]
    uid: np.ndarray      # int32 [T]
    fwd: np.ndarray      # bool  [T]
    enter: np.ndarray    # int32 [T]
    leave: np.ndarray    # int32 [T]
    pos: np.ndarray      # int32 [T]

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1


def _window_placements(codes: torch.Tensor, K: int, table: join.HashedTable):
    """Per window (read, p): unipath id (-1 if absent), orientation along
    the unipath and unipath position of the window. `table` is a
    join.HashedTable whose payloads are (uid, upos, urc), hash-sorted."""
    canon, valid = kmerize.kmer_windows(codes, K)
    shape = canon[0].shape
    found, idx = join.lookup_hashed(
        table.hash_fp, table.bucket_starts, list(table.words),
        [w.reshape(-1) for w in canon], table.shift, table.H)
    uid, upos, urc = table.payloads
    idx = idx.reshape(shape)
    found = found.reshape(shape) & valid
    safe = idx.long().clamp(min=0)
    w_uid = torch.where(found, uid[safe], -1)
    w_rc = urc[safe] != 0
    # the read window is the read's fwd strand and kmer_windows returns the
    # canonical form: orientation in the unipath = (window == canonical)
    # XOR (canonical rc'd in the unipath)
    fwd_words, _ = kmerize.kmer_windows_fwd(codes, K)
    is_canon_fwd = torch.ones_like(found)
    for wf, wc in zip(fwd_words, canon):
        is_canon_fwd &= wf == wc
    w_fwd = torch.where(is_canon_fwd, ~w_rc, w_rc)
    w_pos = torch.where(found, upos[safe], 0)
    return w_uid, w_fwd, w_pos


def path_reads(pl: KmerPlacement, codes: np.ndarray,
               batch_size: int = 8192) -> ReadPaths:
    """Path a read set: device joins + host run compression, one batch of
    `batch_size` reads at a time, on the placement table's device.
    codes: uint8 [N, L] padded with code 4."""
    N, L = codes.shape
    K = pl.K
    device = pl.table[0].device
    # hashed placement table: uid/upos/urc ride as hash-sorted payloads
    table = join.hash_table(
        pl.table,
        payloads=[torch.from_numpy(np.asarray(p, np.int32)).to(device)
                  for p in (pl.uid, pl.upos, pl.urc)])

    # compress per batch (the [N, P] window matrices at genome scale would
    # be tens of GB); ragged ReadPaths pieces concatenate trivially
    piece_offsets = [np.zeros(1, np.int64)]
    piece_arrays = {k: [] for k in ("uid", "fwd", "enter", "leave", "pos")}
    at = 0
    for s in range(0, N, batch_size):
        e = min(s + batch_size, N)
        cb = codes[s:e]
        if e - s < batch_size:
            cb = np.concatenate([cb, np.full((batch_size - (e - s), L), 4,
                                             codes.dtype)])
        u, f, o = _window_placements(pk.device_codes(cb, device), K, table)
        rp = compress_window_paths(u[: e - s].cpu().numpy(),
                                   f[: e - s].cpu().numpy(),
                                   o[: e - s].cpu().numpy())
        piece_offsets.append(rp.offsets[1:] + at)
        at += rp.offsets[-1]
        for k in piece_arrays:
            piece_arrays[k].append(getattr(rp, k))
    cat = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
           for k, v in piece_arrays.items()}
    return ReadPaths(offsets=np.concatenate(piece_offsets),
                     uid=cat["uid"].astype(np.int32),
                     fwd=cat["fwd"].astype(bool),
                     enter=cat["enter"].astype(np.int32),
                     leave=cat["leave"].astype(np.int32),
                     pos=cat["pos"].astype(np.int32))


def compress_window_paths(U: np.ndarray, F: np.ndarray,
                          O: np.ndarray) -> ReadPaths:
    """Host: [N, P] window placements -> ragged ReadPaths.

    A run continues while (uid, fwd) match and the unipath position advances
    by +1 (fwd) / -1 (rc) per window; anything else starts a new entry.
    Windows with uid<0 (absent kmer) belong to no entry.
    """
    N, P = U.shape
    step = np.where(F, 1, -1)
    cont = np.zeros((N, P), bool)
    if P > 1:
        cont[:, 1:] = ((U[:, 1:] == U[:, :-1]) & (U[:, 1:] >= 0)
                       & (F[:, 1:] == F[:, :-1])
                       & (O[:, 1:] == O[:, :-1] + step[:, :-1]))
    is_start = (U >= 0) & ~cont

    r_idx, p_idx = np.nonzero(is_start)
    # leave = next start (or first absent window) minus 1 within the row
    # compute per-window run id then segment max of window index
    run_id = np.cumsum(is_start.reshape(-1)).reshape(N, P) - 1
    in_run = U >= 0
    flat_run = np.where(in_run, run_id, -1).reshape(-1)
    flat_widx = np.tile(np.arange(P, dtype=np.int32), N)
    T = len(r_idx)
    leave = np.zeros(T, np.int32)
    m = flat_run >= 0
    np.maximum.at(leave, flat_run[m], flat_widx[m])

    offsets = np.zeros(N + 1, np.int64)
    np.cumsum(is_start.sum(axis=1), out=offsets[1:])
    return ReadPaths(offsets=offsets,
                     uid=U[r_idx, p_idx].astype(np.int32),
                     fwd=F[r_idx, p_idx],
                     enter=p_idx.astype(np.int32),
                     leave=leave,
                     pos=O[r_idx, p_idx].astype(np.int32))


@dataclasses.dataclass
class PathsDb:
    """CSR inverse of ReadPaths: unipath -> (read, entry index in its path).
    (ref: reads.pathsdb.k96 — the tagged_rpint index)."""
    offsets: np.ndarray  # int64 [n_unipaths + 1]
    read: np.ndarray     # int32 [T]
    entry: np.ndarray    # int32 [T] global row into ReadPaths flat arrays


def build_pathsdb(rp: ReadPaths, n_unipaths: int) -> PathsDb:
    """The reference sorts with its host C++ radix sort, which is stable
    and falls back to this same stable numpy argsort; the order is equal."""
    read_of_entry = np.repeat(np.arange(rp.n_reads, dtype=np.int32),
                              np.diff(rp.offsets))
    order = np.argsort(rp.uid.astype(np.uint64), kind="stable")
    counts = np.bincount(rp.uid, minlength=n_unipaths)
    offsets = np.zeros(n_unipaths + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return PathsDb(offsets=offsets, read=read_of_entry[order],
                   entry=order.astype(np.int32))


def transitions(rp: ReadPaths) -> Tuple[np.ndarray, np.ndarray]:
    """Oriented unipath adjacency transitions crossed by reads.

    Returns (edges [E,4] int32 (a, fla, b, flb), counts [E]) in the
    UniGraph *flip* convention (flag True = unipath traversed reverse-
    complemented; note ReadPaths.fwd is the opposite, traversal-forward).
    Edges are rc-canonicalized: (a,fa)->(b,fb) == (b,!fb)->(a,!fa).
    """
    off = rp.offsets
    # consecutive-entry mask within each read
    T = len(rp.uid)
    nxt_same_read = np.ones(T, bool)
    if T:
        nxt_same_read[off[1:][:-1] - 1] = False  # last entry of each read
        nxt_same_read[-1] = False
    i = np.nonzero(nxt_same_read)[0]
    contig = rp.leave[i] + 1 == rp.enter[i + 1]
    i = i[contig]
    a, fa = rp.uid[i], ~rp.fwd[i]
    b, fb = rp.uid[i + 1], ~rp.fwd[i + 1]
    return count_oriented_edges(a, fa, b, fb)


def count_oriented_edges(a, fa, b, fb):
    """rc-canonicalize oriented edges and count duplicates."""
    ra, rfa, rb, rfb = b, ~fb, a, ~fa
    key_f = pack_edges(a, fa, b, fb)
    key_r = pack_edges(ra, rfa, rb, rfb)
    use_r = key_r < key_f
    key = np.where(use_r, key_r, key_f)
    uniq, counts = np.unique(key, return_counts=True)
    return unpack_edges(uniq), counts.astype(np.int32)


def pack_edges(a, fa, b, fb):
    return ((a.astype(np.int64) << 33) | (fa.astype(np.int64) << 32)
            | (b.astype(np.int64) << 1) | fb.astype(np.int64))


def unpack_edges(key):
    a = (key >> 33).astype(np.int32)
    fa = ((key >> 32) & 1).astype(bool)
    b = ((key >> 1) & ((1 << 31) - 1)).astype(np.int32)
    fb = (key & 1).astype(bool)
    return np.stack([a, fa.astype(np.int32), b, fb.astype(np.int32)],
                    axis=1)

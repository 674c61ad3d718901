"""Friend finding: which reads share sequence with which (port of
allpathslg_tpu/long/friends.py).

Behavior contract (ref: src/paths/long/Friends.{h,cc} `FindFriends` and the
LongProto correction machinery): for every read, the set of "friends" --
reads sharing enough k-mer content to plausibly come from the same locus --
used for friend-stack consensus correction.

Design: all (canonical kmer, read, pos, rc) tuples are flattened and sorted
by (kmer, read) on the device (ops/sort: the Hopper radix sort on the
card); each equal-kmer run pairs the run's reads against the run's first
read (stack growth is clipped by `max_run`). Pair votes are aggregated on
the host into (read a, read b, shared, offset) records where `offset` is
the modal alignment offset of b relative to a. The correction is host
code, a copy of the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.ops import sort as ops_sort


@dataclasses.dataclass
class Friends:
    """Friendship records (a < b unless rc with same id).

    a, b     read ids [F]
    rc       True = b matches a reverse-complemented
    offset   position of b's start in a's coordinates (fwd of a)
    shared   # distinct shared kmers supporting the record
    """
    a: np.ndarray
    b: np.ndarray
    rc: np.ndarray
    offset: np.ndarray
    shared: np.ndarray

    def of(self, r: int) -> np.ndarray:
        """Indices of records involving read r."""
        return np.nonzero((self.a == r) | (self.b == r))[0]


def _kmer_read_pos(codes: torch.Tensor, K: int):
    """Flat (kmer words, read) keys sorted with (pos, window_is_rc) as
    payload, on the codes' device: (read, pos, rc, run starts, sentinel).

    The reference sorts (kmer words, read) with lax.sort(is_stable=False);
    here ops/sort sorts the same keys STABLY (on the card, the Hopper radix
    sort) from read-major, pos-ascending order, so the windows of a k-mer
    that occurs twice in one read keep their pos order."""
    canon, valid = kmerize.kmer_windows(codes, K)
    fwd, _ = kmerize.kmer_windows_fwd(codes, K)
    # window stored rc iff canonical != forward
    is_rc = torch.zeros_like(valid)
    for wf, wc in zip(fwd, canon):
        is_rc = is_rc | (wf != wc)
    N, P = valid.shape
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    dev = codes.device
    read = torch.arange(N, dtype=torch.int64, device=dev).repeat_interleave(P)
    pos = torch.arange(P, dtype=torch.int32, device=dev).repeat(N)
    rcf = is_rc.reshape(-1).to(torch.int32)
    # read id is a SORT KEY (not payload): the pivot of every equal-kmer
    # run is then deterministically the smallest read id, so votes for a
    # (pivot, other) pair accumulate across all kmers of a locus
    skeys, (spos, src) = ops_sort.sort_by_words(flat + [read], [pos, rcf])
    sread = skeys[len(flat)].to(torch.int32)
    kwords = skeys[: len(flat)]
    starts = ops_sort.run_starts(kwords)
    sent = bits.is_sentinel(kwords)
    return sread, spos, src, starts, sent


def find_friends(codes: np.ndarray, K: int = 16, min_shared: int = 3,
                 max_run: int = 32, device="cuda") -> Friends:
    """Find friend pairs among a read batch; the k-mer sort runs on
    `device`.

    codes: uint8 [N, L] (PAD beyond length). Returns Friends with modal
    offsets; a record exists when >= min_shared distinct kmers agree on one
    (rc, offset).
    """
    codes = np.asarray(codes)
    out = _kmer_read_pos(
        torch.from_numpy(np.ascontiguousarray(codes)).to(device), K)
    read, pos, rcf, starts, sent = (t.cpu().numpy() for t in out)
    rcf = rcf.astype(bool)

    T = len(read)
    run_id = np.cumsum(starts) - 1
    keep = ~sent
    run_id, read, pos, rcf = run_id[keep], read[keep], pos[keep], rcf[keep]
    if len(read) == 0:
        z = np.zeros(0, np.int32)
        return Friends(z, z, z.astype(bool), z, z)

    # clip giant runs (repeat kmers): position within run (run_id is sorted)
    within = np.arange(len(read)) - np.searchsorted(run_id, run_id, "left")
    clip = within < max_run
    run_id, read, pos, rcf, within = (x[clip] for x in
                                      (run_id, read, pos, rcf, within))

    # pivot = first tuple of each run; pair every other tuple against it
    first_of_run = np.searchsorted(run_id, run_id, side="left")
    pa, ppos, prc = read[first_of_run], pos[first_of_run], rcf[first_of_run]
    m = within > 0
    a, b = pa[m], read[m]
    apos, bpos = ppos[m], pos[m]
    arc, brc = prc[m], rcf[m]
    same = a == b
    a, b, apos, bpos, arc, brc = (x[~same] for x in
                                  (a, b, apos, bpos, arc, brc))
    if len(a) == 0:
        z = np.zeros(0, np.int32)
        return Friends(z, z, z.astype(bool), z, z)

    # orient: rc record iff the two windows disagree in orientation.
    rc_rec = arc != brc
    # offset of b's start (after rc'ing b when rc_rec) in a's fwd coords:
    # fwd/fwd: apos - bpos; rc: the window at b-position bpos sits at
    # rc-position Lb - K - bpos of rc(b), so offset = apos - (Lb - K - bpos).
    lens = (codes < 4).sum(axis=1).astype(np.int64)
    off = np.where(rc_rec,
                   apos + bpos + K - lens[b],
                   apos - bpos).astype(np.int64)

    # aggregate votes per (a, b, rc, off)
    key = (a.astype(np.int64) << 40) ^ (b.astype(np.int64) << 16) \
        ^ (rc_rec.astype(np.int64) << 15) ^ (off & 0x7FFF)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, first, counts = np.unique(key_s, return_index=True,
                                    return_counts=True)
    sel = order[first]
    good = counts >= min_shared
    return Friends(a=a[sel][good].astype(np.int32),
                   b=b[sel][good].astype(np.int32),
                   rc=rc_rec[sel][good],
                   offset=off[sel][good].astype(np.int32),
                   shared=counts[good].astype(np.int32))


def correct_with_friends(codes: np.ndarray, fr: Friends,
                         min_depth: int = 3,
                         min_ratio: float = 3.0) -> Tuple[np.ndarray, int]:
    """Friend-stack consensus correction (the LongProto correction step).

    For each read, stack friend reads at their modal offsets and re-call
    each base by weighted majority when the pile is deep enough and
    dominant enough (ratio of best to runner-up). Returns (corrected
    codes, n_bases_changed). Host implementation over ragged stacks —
    the per-base vote is vectorized per read.
    """
    out = codes.copy()
    N, L = codes.shape
    lens = (codes < 4).sum(axis=1)
    n_changed = 0
    # Offset convention: record (r, q, rc, off) = q's content (rc'd when rc)
    # occupies positions [off, off + Lq) of r's forward frame. For rc
    # records, r-position t holds q's base at q-position (off + Lq - 1 - t),
    # complemented.
    by_read = [dict() for _ in range(N)]

    def _add(r, q, rc, off):
        if q != r and (q, rc) not in by_read[r]:
            by_read[r][(q, rc)] = int(off)

    for i in range(len(fr.a)):
        a, b = int(fr.a[i]), int(fr.b[i])
        rc, off = bool(fr.rc[i]), int(fr.offset[i])
        _add(a, b, rc, off)
        # mirror record, a laid on b's frame
        if not rc:
            _add(b, a, False, -off)
        else:
            _add(b, a, True, off + int(lens[b]) - int(lens[a]))
    # transitive expansion through pivots: r inherits its friends' friends
    # (pivot reads carry the locus's full stack; one hop spreads it)
    direct = [list(d.items()) for d in by_read]
    for r in range(N):
        for ((p, rc_r), off_r) in direct[r]:
            # p laid on r at off_r; q laid on p at off_q → q laid on r
            for ((q, rc_q), off_q) in direct[p]:
                if not rc_r:
                    _add(r, q, rc_q, off_r + off_q)
                else:
                    _add(r, q, not rc_q,
                         off_r + int(lens[p]) - off_q - int(lens[q]))
    for r in range(N):
        if not by_read[r]:
            continue
        Lr = int(lens[r])
        votes = np.zeros((4, Lr), np.int32)
        base_r = codes[r, :Lr]
        ok = base_r < 4
        votes[base_r[ok], np.nonzero(ok)[0]] += 2  # self weight
        for (q, rc), off in by_read[r].items():
            Lq = int(lens[q])
            seq = codes[q, :Lq]
            if rc:
                valid_q = seq < 4
                seq = np.where(valid_q[::-1], 3 - seq[::-1], 4).astype(seq.dtype)
            start = off
            lo = max(0, start)
            hi = min(Lr, start + Lq)
            if hi <= lo:
                continue
            frag = seq[lo - start : hi - start]
            m = frag < 4
            cols = np.arange(lo, hi)[m]
            votes[frag[m], cols] += 1
        depth = votes.sum(axis=0)
        best = votes.argmax(axis=0).astype(np.uint8)
        bestv = votes.max(axis=0)
        votes_sorted = np.sort(votes, axis=0)
        second = votes_sorted[-2]
        fix = (depth >= min_depth) & (bestv >= min_ratio * np.maximum(second, 1)) \
            & (best != base_r) & (base_r < 4)
        if fix.any():
            out[r, :Lr] = np.where(fix, best, base_r)
            n_changed += int(fix.sum())
    return out, n_changed

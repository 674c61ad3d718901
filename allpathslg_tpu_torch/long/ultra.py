"""Ultra: high-error (PacBio CLR ~15%) long-read consensus correction (port
of allpathslg_tpu/long/ultra.py).

Behavior contract (ref: src/paths/long/ultra/ -- the MultipleAligner /
ConsensusScoreModel machinery, SURVEY.md §2.5 long-read extensions): correct
noisy long reads by stacking each read's *friends* (reads sharing k-mer
content at a locus), aligning friend fragments against the read, and
re-calling every base -- substitutions, deletions AND insertions -- from the
aligned pileup.

Alignment problems are WINDOWED: every (read, friend) overlap is cut into
fixed-size fragment-vs-window problems anchored at a shared k-mer hit
inside the window, so the residual drift within a problem is bounded by
band. Cost model: sub=3, gap=2; free fragment ends, the window axis fully
consumed -- a window base aligned to a fragment gap is a deletion VOTE, a
fragment base between window bases an insertion VOTE.

On the device (the card by default): the friend k-mer sort (ops/sort, the
Hopper radix sort on the card) and the banded DP with its traceback, which
the reference runs as two `lax.scan`s (XLA programs, no Pallas kernel) and
the port as Python loops of torch ops, one launch group a step. The rest
is the reference's host numpy, copied: the hit pairing, the problem build
(one row copy per problem) and the consensus emit.

Where the reference leaves an order or a rounding open, the port fixes it:
- friend_hits sorts the k-mer words stably, from read-major, pos-ascending
  order; the reference's `lax.sort(..., is_stable=False)` leaves the order
  of a run's (read, pos) tuples to XLA, and that order decides the max_run
  clip and which hit of a (read, friend, window) the lexsort keeps;
- the traceback's alive threshold is float32 `1.3 * max(wlen, 1)`, as the
  reference's device path computes it; its host oracle computes it in
  float64, which differs at 113 of the window lengths 1-4999 (wlen 90:
  116 vs 117). The port's host oracle is a copy, float64 included.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from allpathslg_tpu_torch.kmer import bits, kmerize
from allpathslg_tpu_torch.ops import sort as ops_sort

BIG = 1 << 20
# the reference's float32 factor of the alive threshold
ALIVE_FACTOR = np.float32(1.3)


@dataclasses.dataclass(frozen=True)
class UltraConfig:
    friend_k: int = 14        # anchor k-mer (0.85^2k of sites are clean pairs)
    window: int = 256         # target window width
    margin: int = 48          # fragment margin each side (also the band)
    max_run: int = 24         # cap per-kmer stack (repeat clip)
    max_frags_per_window: int = 12
    min_cov: int = 2          # friend coverage below which bases stay put
    rounds: int = 2
    sub_cost: int = 3
    gap_cost: int = 2


# ---------------------------------------------------------------------------
# friend hits: (a, b, apos, bpos, rc) -- all pairs within equal-kmer runs
# ---------------------------------------------------------------------------


def _pack_reads(reads: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(r) for r in reads], np.int64)
    L = int(lens.max())
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    return codes, lens


def _sorted_hits(codes: torch.Tensor, K: int):
    """(read, pos, window_is_rc, run starts, sentinel) of every k-mer
    window, sorted by the canonical k-mer words alone, stably, on the
    codes' device."""
    canon, valid = kmerize.kmer_windows(codes, K)
    fwd, _ = kmerize.kmer_windows_fwd(codes, K)
    is_rc = torch.zeros_like(valid)
    for wf, wc in zip(fwd, canon):
        is_rc = is_rc | (wf != wc)
    N, P = valid.shape
    flat, _ = kmerize.flatten_kmers(canon, valid, K)
    dev = codes.device
    read = torch.arange(N, dtype=torch.int32, device=dev).repeat_interleave(P)
    pos = torch.arange(P, dtype=torch.int32, device=dev).repeat(N)
    skeys, (sread, spos, src) = ops_sort.sort_by_words(
        flat, [read, pos, is_rc.reshape(-1).to(torch.int32)])
    return (sread, spos, src, ops_sort.run_starts(skeys),
            bits.is_sentinel(skeys))


def friend_hits(reads: Sequence[np.ndarray], K: int = 14,
                max_run: int = 24, device="cuda"):
    """All-pairs k-mer hits between reads: arrays (a, b, apos, bpos, rc).

    a/b read ids, apos/bpos window positions in each read's OWN forward
    frame, rc True when the two windows matched in opposite orientation.
    Pairs within an equal-canonical-kmer run of the sort (on `device`),
    capped at max_run tuples per run (repeat clip, as the reference's
    friend finder caps stack growth).
    """
    codes, lens = _pack_reads(reads)
    out = _sorted_hits(torch.from_numpy(codes).to(device), K)
    read, pos, rcf, starts, sent = (t.cpu().numpy() for t in out)
    rcf = rcf.astype(bool)
    keep = ~sent
    run_id = np.cumsum(starts) - 1
    run_id, read, pos, rcf = (x[keep] for x in (run_id, read, pos, rcf))
    if len(read) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z.astype(bool)

    first = np.searchsorted(run_id, run_id, side="left")
    within = np.arange(len(read)) - first
    clip = within < max_run
    run_id, read, pos, rcf = (x[clip] for x in (run_id, read, pos, rcf))
    # recompute run extents on the clipped arrays (stale pre-clip indices
    # would mix coordinate systems)
    first = np.searchsorted(run_id, run_id, side="left")
    within = np.arange(len(read)) - first
    last = np.searchsorted(run_id, run_id, side="right")  # exclusive
    rl = last - first
    # all ordered pairs (i, j), i != j, within each run: expand via repeat
    tot = int((rl * (rl - 1)).sum()) if len(rl) else 0
    if tot == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z.astype(bool)
    # row r of run appears (rl-1) times as "a"
    a_idx = np.repeat(np.arange(len(read)), rl - 1)
    # partner index: enumerate run members excluding self
    k = (np.arange(len(a_idx))
         - np.repeat(np.cumsum(np.concatenate([[0], (rl - 1)[:-1]])),
                     rl - 1))
    b_idx = np.repeat(first, rl - 1) + k + (k >= np.repeat(within, rl - 1))
    a, b = read[a_idx], read[b_idx]
    apos, bpos = pos[a_idx], pos[b_idx]
    rc = rcf[a_idx] != rcf[b_idx]
    ok = a != b
    return (a[ok].astype(np.int64), b[ok].astype(np.int64),
            apos[ok].astype(np.int64), bpos[ok].astype(np.int64), rc[ok])


# ---------------------------------------------------------------------------
# batched banded DP with traceback -- device path
# ---------------------------------------------------------------------------


def _votes_forward(win, frag, flen_c, wlen_c, Lt: int, Lq: int, band: int,
                   sub: int, gap: int):
    """The DP's forward pass over window rows 1..Lt, on the inputs'
    device: (choices int8 [Lt, B, W2], Dend int32 [B, W2]).

    Band slot k of window row i holds fragment position j = i + k (the
    fragment carries a `band`-wide margin before the anchor); diag = same
    slot prev row, up = slot k+1 prev row, left = slot k-1 same row, the
    left chain collapsed by the min-plus cummin. choice: 0 diag, 1 up,
    2 left, ties resolved diag, then up, then left (is_left strict). The
    int32 arithmetic is the reference's: out-of-band cells carry BIG plus
    what was added to them, unclamped."""
    dev = win.device
    i32 = torch.int32
    B = win.shape[0]
    W2 = 2 * band + 1
    ks = torch.arange(W2, dtype=i32, device=dev)
    ramp = (ks * gap)[None, :]
    flen2 = flen_c[:, None]
    # (f == w) & (f < 4) & (w < 4) is f == w with the window's codes >= 4
    # replaced by -1, which no fragment code equals
    winq = torch.where(win < 4, win.to(i32), -1)
    # fragment codes with 4 past Lq: slot k of row i reads column i - 1 + k
    fragp = torch.cat([frag.to(i32),
                       torch.full((B, W2 + max(Lt - Lq, 0)), 4, dtype=i32,
                                  device=dev)], 1)
    # row i's masks as one compare each: diag needs j <= Lq and
    # j - 1 <= flen, i.e. i <= min(flen + 1, Lq) - k; a cell needs j <= flen
    diag_last = torch.clamp(flen2 + 1, max=Lq) - ks[None, :]
    cell_last = flen2 - ks[None, :]
    Dp = torch.where(cell_last >= 0, 0, BIG).to(i32)
    Dend = torch.where((wlen_c == 0)[:, None], Dp, BIG).to(i32)
    choices = torch.empty((Lt, B, W2), dtype=torch.int8, device=dev)
    up = torch.empty((B, W2), dtype=i32, device=dev)
    up[:, -1] = BIG + gap
    for i in range(1, Lt + 1):
        fj = fragp[:, i - 1:i - 1 + W2]
        diag = torch.where(fj == winq[:, i - 1:i], Dp, Dp + sub)
        diag.masked_fill_(diag_last < i, BIG)
        torch.add(Dp[:, 1:], gap, out=up[:, :-1])
        cur = torch.minimum(diag, up)
        # the left chain; r <= cur slot by slot, so min(cur, r) is r
        r = torch.cummin(cur - ramp, dim=1).values + ramp
        is_left = r < cur
        off = cell_last < i
        r.masked_fill_(off, BIG)
        ch = choices[i - 1]
        ch.copy_(diag > up)
        ch.masked_fill_(is_left & ~off, 2)
        Dend = torch.where((wlen_c == i)[:, None], r, Dend)
        Dp = r
    return choices, Dend


# steps between the traceback's checks for problems still walking
TRACE_CHECK_EVERY = 32


def _votes_traceback(choices, Dend, frag, wlen_c, Lt: int, Lq: int):
    """Replays the forward pass's choices from each problem's best end,
    all problems together, on the device: (ev_i int32, ev_kind int8,
    ev_base int8), each [steps, B], one event a problem a step (ev_i = -1
    where none). The reference runs all Lt + Lq + 2 steps; the port stops
    once no problem walks, which drops only steps without an event."""
    dev = Dend.device
    i32 = torch.int32
    B, W2 = Dend.shape
    n_steps = Lt + Lq + 2
    end_k = torch.argmin(Dend, dim=1).to(i32)
    best = Dend.min(dim=1).values
    limit = (torch.tensor(ALIVE_FACTOR, dtype=torch.float32, device=dev)
             * torch.clamp(wlen_c, min=1).to(torch.float32)).to(i32)
    alive = (best < BIG) & (best < limit)
    ch_flat = choices.reshape(-1)
    fragj = frag.to(i32)
    bidx = torch.arange(B, dtype=torch.int64, device=dev)
    ev_i = torch.full((n_steps, B), -1, dtype=i32, device=dev)
    ev_kind = torch.empty((n_steps, B), dtype=torch.int8, device=dev)
    ev_base = torch.empty((n_steps, B), dtype=torch.int8, device=dev)
    i, k = wlen_c.to(i32), end_k
    for step in range(n_steps):
        act = alive & (i > 0)
        if step % TRACE_CHECK_EVERY == 0 and not bool(act.any()):
            return ev_i[:step], ev_kind[:step], ev_base[:step]
        ii = torch.clamp(i, min=1).to(torch.int64)
        ch = ch_flat[((ii - 1) * B + bidx) * W2 + k]
        is_diag = act & (ch == 0)
        is_up = act & (ch == 1)
        is_left = act & (ch == 2)
        j = i + k                                      # i + band + k - band
        fj = torch.where((j >= 1) & (j <= Lq),
                         fragj[bidx, torch.clamp(j - 1, 0, Lq - 1)], 4)
        step_i = is_diag | is_up
        ev_i[step] = torch.where(step_i, i - 1, torch.where(is_left, i, -1))
        ev_kind[step] = torch.where(is_diag, 0, torch.where(is_up, 1, 2))
        ev_base[step] = torch.where(is_up, 0, fj)
        i = i - step_i.to(i32)
        k = torch.where(is_up, torch.clamp(k + 1, max=W2 - 1),
                        torch.where(is_left, torch.clamp(k - 1, min=0), k))
    return ev_i, ev_kind, ev_base


def _banded_votes_kernel(win, frag, flen, wlen, Lt: int, Lq: int,
                         band: int, sub: int, gap: int):
    """DP + traceback for one padded problem chunk on the tensors' device:
    (ev_i, ev_kind, ev_base), each [steps, B]."""
    flen_c = torch.clamp(flen, max=Lq).to(torch.int32)
    wlen_c = torch.clamp(wlen, max=Lt).to(torch.int32)
    choices, Dend = _votes_forward(win, frag, flen_c, wlen_c, Lt, Lq, band,
                                   sub, gap)
    return _votes_traceback(choices, Dend, frag, wlen_c, Lt, Lq)


def _banded_votes(win: np.ndarray, frag: np.ndarray, flen: np.ndarray,
                  wlen: np.ndarray, band: int, sub: int, gap: int,
                  chunk: int = 8192, device="cuda"):
    """Device-batched banded DP + traceback; returns the same event tuple
    as the host oracle, in the reference's order: chunks of `chunk`
    problems (padded with empty rows when there is more than one), events
    step-major within a chunk."""
    B, Lt = win.shape
    Lq = frag.shape[1]
    if B == 0:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.int8), z.astype(np.int8), z
    out_i, out_k, out_b, out_p = [], [], [], []
    for s in range(0, B, chunk):
        e = min(s + chunk, B)
        n = e - s
        pad = chunk - n if B > chunk else 0
        wv, fv = win[s:e], frag[s:e]
        fl, wl = flen[s:e], wlen[s:e]
        if pad:
            wv = np.concatenate([wv, np.full((pad, Lt), 4, np.uint8)])
            fv = np.concatenate([fv, np.full((pad, Lq), 4, np.uint8)])
            fl = np.concatenate([fl, np.zeros(pad, fl.dtype)])
            wl = np.concatenate([wl, np.zeros(pad, wl.dtype)])
        ti, tk, tb = _banded_votes_kernel(
            *(torch.from_numpy(np.ascontiguousarray(x)).to(device)
              for x in (wv, fv, fl, wl)), Lt=Lt, Lq=Lq, band=band,
            sub=sub, gap=gap)
        ti = ti.cpu().numpy()[:, :n]
        tk = tk.cpu().numpy()[:, :n]
        tb = tb.cpu().numpy()[:, :n]
        m = ti >= 0
        probs = np.broadcast_to(np.arange(s, e, dtype=np.int64)[None, :],
                                ti.shape)
        out_i.append(ti[m].astype(np.int64))
        out_k.append(tk[m])
        out_b.append(tb[m])
        out_p.append(probs[m])
    return (np.concatenate(out_i), np.concatenate(out_k),
            np.concatenate(out_b), np.concatenate(out_p))


# ---------------------------------------------------------------------------
# batched banded DP with traceback (host numpy oracle -- kept for tests)
# ---------------------------------------------------------------------------


def _banded_votes_host(win: np.ndarray, frag: np.ndarray, flen: np.ndarray,
                       wlen: np.ndarray, band: int, sub: int, gap: int):
    """Align each fragment to its window; return per-problem vote events.

    win  [B, Lt] uint8 window bases (the read being corrected); rows padded 4
    frag [B, Lq] uint8 fragment bases; glocal -- free fragment ends
    Returns (ev_i, ev_kind, ev_base, ev_prob): alignment events with
    ev_kind 0=match/sub (base at window pos i), 1=del (window pos i against
    gap), 2=ins (base between window pos i-1 and i).
    """
    B, Lt = win.shape
    Lq = frag.shape[1]
    W2 = 2 * band + 1
    BIG = np.int32(1 << 20)
    # D[i, :, k]: cost for window prefix i, fragment position
    # j = i + band + k - band = i + k  (anchor maps window i -> fragment
    # i + band: fragments carry a `band`-wide margin before the anchor)
    off0 = band
    D = np.full((Lt + 1, B, W2), BIG, np.int32)
    j0 = np.arange(W2) + off0 - band  # fragment j at i=0
    D[0][:, :] = np.where((j0 >= 0) & (j0[None, :] <= flen[:, None]), 0, BIG)
    ks = np.arange(W2)
    for i in range(1, Lt + 1):
        j = i + off0 + ks - band              # [W2] fragment position
        jv = (j >= 1) & (j <= Lq)
        # fragment base at j-1 per problem
        fj = np.where(jv[None, :], frag[:, np.clip(j - 1, 0, Lq - 1)], 4)
        wb = win[:, i - 1][:, None]
        diag = D[i - 1] + np.where((fj == wb) & (fj < 4) & (wb < 4), 0, sub)
        diag = np.where(jv[None, :] & (j[None, :] - 1 <= flen[:, None]),
                        diag, BIG)
        up = np.concatenate([D[i - 1][:, 1:], np.full((B, 1), BIG)],
                            axis=1) + gap    # window base vs gap
        cur = np.minimum(diag, up)
        # left (fragment base vs gap, same i): min-plus prefix along k
        run = np.full(B, BIG, np.int64)
        curT = cur.T  # [W2, B] view for the scan
        for k in range(W2):
            run = np.minimum(run + gap, curT[k])
            curT[k] = run
        # forbid j out of range for this i
        D[i] = np.where((j[None, :] >= 0) &
                        (j[None, :] <= np.minimum(Lq, flen)[:, None]),
                        cur, BIG)
    # free fragment suffix: end at (wlen, any j >= anchor)  -- per problem,
    # the window may be shorter than Lt (ragged): gather row wlen[b]
    Dend = D[wlen, np.arange(B)]              # [B, W2]
    end_k = Dend.argmin(axis=1)
    # vectorized traceback: all problems walk together
    i = wlen.astype(np.int64).copy()
    k = end_k.astype(np.int64)
    best = Dend[np.arange(B), end_k]
    # misanchor filter: a genuine overlap of two 15%-error reads costs
    # ~0.7-0.9 per window base; a spurious k-mer collision aligns at
    # ~75% difference (~1.8+/base). Excluding those keeps collision noise
    # out of the pileup (the reference's MultipleAligner keeps only
    # friends whose alignment validates).
    alive = (best < BIG) & (best < np.int64(1.3 * np.maximum(wlen, 1)))
    ev_i, ev_kind, ev_base, ev_prob = [], [], [], []
    bidx = np.arange(B)
    Dt = D  # [Lt+1, B, W2]
    for _ in range(Lt + Lq + 2):
        act = alive & (i > 0)
        if not act.any():
            break
        j = i + off0 + k - band
        cd = Dt[np.maximum(i - 1, 0), bidx, k]
        fj = np.where((j >= 1) & (j <= Lq),
                      frag[bidx, np.clip(j - 1, 0, Lq - 1)], 4)
        wb = win[bidx, np.clip(i - 1, 0, Lt - 1)]
        sub_c = np.where((fj == wb) & (fj < 4) & (wb < 4), 0, sub)
        cur = Dt[i, bidx, k]
        is_diag = act & (cd + sub_c == cur)
        ku = np.minimum(k + 1, W2 - 1)
        is_up = act & ~is_diag & (Dt[np.maximum(i - 1, 0), bidx, ku] + gap
                                  == cur) & (k + 1 < W2)
        kl = np.maximum(k - 1, 0)
        is_left = act & ~is_diag & ~is_up & (k - 1 >= 0) & \
            (Dt[i, bidx, kl] + gap == cur)
        # j == 0 with i > 0 can only go up (shouldn't occur in-band)
        stuck = act & ~is_diag & ~is_up & ~is_left
        is_up = is_up | stuck
        # emit events for active problems
        em = is_diag
        if em.any():
            ev_i.append(np.where(em, i - 1, -1))
            ev_kind.append(np.zeros(B, np.int8))
            ev_base.append(fj.astype(np.int8))
        dm = is_up
        if dm.any():
            ev_i.append(np.where(dm, i - 1, -1))
            ev_kind.append(np.ones(B, np.int8))
            ev_base.append(np.zeros(B, np.int8))
        lm = is_left
        if lm.any():
            ev_i.append(np.where(lm, i, -1))
            ev_kind.append(np.full(B, 2, np.int8))
            ev_base.append(fj.astype(np.int8))
        i = i - (is_diag | is_up)
        k = np.where(is_diag, k, np.where(is_up, k + 1,
                                          np.where(is_left, k - 1, k)))
    if not ev_i:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.int8), z.astype(np.int8), z
    nev = len(ev_i)
    probs = np.tile(bidx, nev)
    ii = np.concatenate(ev_i)
    kk = np.concatenate(ev_kind)
    bb = np.concatenate(ev_base)
    m = ii >= 0
    return ii[m], kk[m], bb[m], probs[m]


# ---------------------------------------------------------------------------
# windowed correction rounds
# ---------------------------------------------------------------------------


def _select_hits(a, b, apos, bpos, rc, cfg: UltraConfig):
    """Each hit to the window of its a-position; per (a, b, rc, window) the
    hit closest to the window's center, then at most max_frags_per_window
    hits per (a, window). Returns (a, b, apos, bpos, rc, wid)."""
    Wn = cfg.window
    wid = apos // Wn
    center_d = np.abs((apos % Wn) - Wn // 2)
    gkey = (a << 40) | (b << 16) | (rc.astype(np.int64) << 15) | wid
    order = np.lexsort((center_d, gkey))
    gk_s = gkey[order]
    first = np.searchsorted(gk_s, gk_s, side="left")
    keep = order[np.unique(first)]
    a, b, apos, bpos, rc, wid = (x[keep] for x in (a, b, apos, bpos, rc, wid))

    # cap fragments per (a, window)
    awkey = a * (1 << 20) + wid
    order = np.argsort(awkey, kind="stable")
    awk_s = awkey[order]
    within = np.arange(len(order)) - np.searchsorted(awk_s, awk_s, "left")
    keep = order[within < cfg.max_frags_per_window]
    return tuple(x[keep] for x in (a, b, apos, bpos, rc, wid))


def _build_problems(reads: List[np.ndarray], a, b, apos, bpos, rc, wid,
                    cfg: UltraConfig):
    """Window and fragment rows of every problem (host gather loop -- O(B)
    rows of memcpy): (win, frag, flen, wlen, wbase)."""
    Wn, M = cfg.window, cfg.margin
    B = len(a)
    Lt, Lq = Wn, Wn + 2 * M
    win = np.full((B, Lt), 4, np.uint8)
    frag = np.full((B, Lq), 4, np.uint8)
    wlen = np.zeros(B, np.int64)
    flen = np.zeros(B, np.int64)
    wbase = wid * Wn
    for p in range(B):
        r = reads[a[p]]
        ws = int(wbase[p])
        we = min(ws + Wn, len(r))
        win[p, : we - ws] = r[ws:we]
        wlen[p] = we - ws
        q = reads[b[p]]
        if rc[p]:
            qo = (3 - q[::-1]).astype(np.uint8)
            qo[q[::-1] > 3] = 4
            banchor = len(q) - cfg.friend_k - int(bpos[p])
        else:
            qo = q
            banchor = int(bpos[p])
        # fragment spans b-positions matching [ws - M, ws - M + Lq) of a
        fs = banchor - (int(apos[p]) - ws) - M
        fe = fs + Lq
        cs, ce = max(0, fs), min(len(qo), fe)
        if ce <= cs:
            continue
        frag[p, cs - fs : ce - fs] = qo[cs:ce]
        flen[p] = ce - fs
    return win, frag, flen, wlen, wbase


def _consensus(reads: List[np.ndarray], lens: np.ndarray, a, wbase, events,
               cfg: UltraConfig) -> Tuple[List[np.ndarray], int]:
    """Scatter the vote events into per-base pileups over the concatenated
    reads and re-call every read: (new reads, n_events_changed)."""
    ev_i, ev_kind, ev_base, ev_prob = events
    off = np.zeros(len(reads) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    G = int(off[-1])
    sub_votes = np.zeros((G, 4), np.int32)
    del_votes = np.zeros(G, np.int32)
    ins_votes = np.zeros((G + len(reads), 4), np.int32)  # +1 slot per read
    cover = np.zeros(G, np.int32)

    gpos = off[a[ev_prob]] + wbase[ev_prob] + ev_i
    rd = a[ev_prob]
    mm = ev_kind == 0
    okb = mm & (ev_base < 4)
    np.add.at(sub_votes, (gpos[okb], ev_base[okb].astype(np.int64)), 1)
    np.add.at(cover, gpos[mm], 1)
    dd = ev_kind == 1
    np.add.at(del_votes, gpos[dd], 1)
    np.add.at(cover, gpos[dd], 1)
    ii = ev_kind == 2
    ipos = off[rd[ii]] + rd[ii] + wbase[ev_prob[ii]] + ev_i[ii]
    oki = ev_base[ii] < 4
    np.add.at(ins_votes, (ipos[oki] , ev_base[ii][oki].astype(np.int64)), 1)

    # consensus emit per read (vectorized per read)
    out: List[np.ndarray] = []
    n_changed = 0
    for r in range(len(reads)):
        s, e = off[r], off[r + 1]
        L = int(e - s)
        sv = sub_votes[s:e].copy()
        base = reads[r][:L]
        okb_ = base < 4
        sv[np.arange(L)[okb_], base[okb_]] += 1          # self vote
        dv = del_votes[s:e]
        cv = cover[s:e] + 1
        iv = ins_votes[s + r : e + r + 1]
        deep = cv - 1 >= cfg.min_cov
        drop = deep & (2 * dv > cv)
        call = np.where(deep, sv.argmax(axis=1).astype(np.uint8), base)
        ins_best = iv.argmax(axis=1).astype(np.uint8)
        ins_n = iv.max(axis=1)
        # insert before position i when a majority of covering friends saw
        # an extra base there (coverage at the junction ~ cover of i)
        covj = np.concatenate([cv, cv[-1:]])[: L + 1]
        do_ins = (ins_n * 2 > covj) & \
            (np.concatenate([deep, deep[-1:]])[: L + 1])
        # build output
        pieces = []
        n_changed += int((call != base).sum()) + int(drop.sum()) \
            + int(do_ins.sum())
        keepm = ~drop
        if not do_ins.any():
            pieces = call[keepm]
        else:
            outbuf = []
            ins_at = np.flatnonzero(do_ins)
            prev = 0
            for t in ins_at:
                outbuf.append(call[prev:t][keepm[prev:t]])
                outbuf.append(ins_best[t : t + 1])
                prev = t
            outbuf.append(call[prev:][keepm[prev:]])
            pieces = np.concatenate(outbuf)
        out.append(np.asarray(pieces, np.uint8))
    return out, n_changed


def correct_round(reads: List[np.ndarray], cfg: UltraConfig, device="cuda"
                  ) -> Tuple[List[np.ndarray], int]:
    """One ultra correction round over all reads, the friend sort and the
    DP on `device`. Returns (new_reads, n_events_changed)."""
    a, b, apos, bpos, rc = friend_hits(reads, K=cfg.friend_k,
                                       max_run=cfg.max_run, device=device)
    lens = np.array([len(r) for r in reads], np.int64)
    if len(a) == 0:
        return [r.copy() for r in reads], 0
    a, b, apos, bpos, rc, wid = _select_hits(a, b, apos, bpos, rc, cfg)
    win, frag, flen, wlen, wbase = _build_problems(reads, a, b, apos, bpos,
                                                   rc, wid, cfg)
    # window pos i matches fragment pos i + M: the band is centered at +M
    events = _banded_votes(win, frag, flen, wlen, band=cfg.margin,
                           sub=cfg.sub_cost, gap=cfg.gap_cost, device=device)
    return _consensus(reads, lens, a, wbase, events, cfg)


def correct_long_reads(reads: Sequence[np.ndarray],
                       cfg: UltraConfig = UltraConfig(), device="cuda"
                       ) -> Tuple[List[np.ndarray], dict]:
    """Ultra consensus correction: iterated windowed friend-pileup rounds,
    the device work on `device`. Returns (corrected reads, metrics)."""
    cur = [np.asarray(r, np.uint8) for r in reads]
    metrics = {}
    for rnd in range(cfg.rounds):
        cur, n = correct_round(cur, cfg, device=device)
        metrics[f"round{rnd}_events"] = int(n)
        if n == 0:
            break
    return cur, metrics

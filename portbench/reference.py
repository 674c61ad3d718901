"""The plain reference that decides `correct`: numpy only. It imports
nothing of the program and takes nothing the program made, except the
outputs it judges.

- `spectrum`: the 25-mer spectrum of a read set (spec[f] = distinct
  canonical 25-mers seen f times, f clipped to 255, spec[0] = 0).
- `banded_cost`: the glocal banded edit cost, a numpy copy of the
  semantics of the port's plain `ops/banded.banded_align` (query
  global, target free at both ends within the band).
- `placement_errors`: judges stated read placements on stated contigs.
- `unplaced_pct`: the share of the fragment reads left unplaced.
- `kmer_set` / `assembly_vs_genome`: an assembly's 25-mers against the
  genome the benchmark generated.
"""

from __future__ import annotations

import numpy as np

K_SPECTRUM = 25          # validate_inputs' K
MAX_FREQ = 255           # its spectrum clip
K_ASSEMBLY = 25
BIG = 1 << 20


def _windows(codes: np.ndarray, lengths: np.ndarray, K: int):
    """Canonical K-mers (K <= 31) of reads [N, L] as int64 [N, P], and
    which windows are valid (inside the read, no code >= 4); each window
    rolls from the one before it."""
    codes = np.asarray(codes, np.uint8)
    N, L = codes.shape
    P = L - K + 1
    inside = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    bad = (codes >= 4) | ~inside
    cs = np.concatenate([np.zeros((N, 1), np.int32),
                         np.cumsum(bad, axis=1, dtype=np.int32)], axis=1)
    valid = (cs[:, K:] - cs[:, :P]) == 0
    c = np.where(bad, 0, codes).astype(np.int64).T      # [L, N]
    mask = (1 << (2 * K)) - 1
    fwd = np.empty((P, N), np.int64)
    rev = np.empty((P, N), np.int64)
    f = np.zeros(N, np.int64)
    r = np.zeros(N, np.int64)
    for j in range(K):
        f = (f << 2) | c[j]
        r |= (3 - c[j]) << (2 * j)
    fwd[0], rev[0] = f, r
    for p in range(1, P):
        f = ((f << 2) | c[p + K - 1]) & mask
        r = (r >> 2) | ((3 - c[p + K - 1]) << (2 * (K - 1)))
        fwd[p], rev[p] = f, r
    return np.minimum(fwd, rev).T, valid


def canonical_kmers(codes, lengths, K: int, rows_a_block: int = 1 << 16):
    """Every valid canonical K-mer of the reads, flat int64."""
    out = []
    for s in range(0, len(codes), rows_a_block):
        can, valid = _windows(codes[s:s + rows_a_block],
                              lengths[s:s + rows_a_block], K)
        out.append(can[valid])
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def spectrum(codes, lengths, K: int = K_SPECTRUM,
             max_freq: int = MAX_FREQ) -> np.ndarray:
    _, counts = np.unique(canonical_kmers(codes, lengths, K),
                          return_counts=True)
    spec = np.bincount(np.minimum(counts, max_freq),
                       minlength=max_freq + 1).astype(np.int64)
    spec[0] = 0
    return spec


def kmer_set(bases: np.ndarray, offsets: np.ndarray, K: int = K_ASSEMBLY):
    """(sorted distinct canonical K-mers, every valid window's K-mer, the
    count of valid windows) of a flat sequence set (bases uint8, offsets
    int64 [n + 1]): windows that lie inside one sequence and hold no code
    >= 4 (N, gap)."""
    b = np.asarray(bases, np.uint8)
    offsets = np.asarray(offsets, np.int64)
    M = len(b) - K + 1
    if M <= 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, 0
    seq_end = np.repeat(offsets[1:], np.diff(offsets))[:M]
    bad = np.concatenate([[0], np.cumsum(b >= 4)])
    valid = ((np.arange(M) + K <= seq_end)
             & (bad[K:K + M] - bad[:M] == 0))
    c = np.where(b >= 4, 0, b).astype(np.int64)
    fwd = np.zeros(M, np.int64)
    rev = np.zeros(M, np.int64)
    for j in range(K):
        fwd = (fwd << 2) | c[j:j + M]
        rev |= (3 - c[j:j + M]) << (2 * j)
    flat = np.minimum(fwd, rev)[valid]
    return np.unique(flat), flat, len(flat)


def assembly_vs_genome(bases, offsets, genome_kmers: np.ndarray) -> dict:
    """asm_err_ppm: the assembly's 25-mer windows absent from the genome,
    per million windows; genome_miss_pct: the genome's distinct 25-mers
    absent from the assembly, in %."""
    distinct, flat, n = kmer_set(bases, offsets)
    absent = int((~np.isin(flat, genome_kmers, assume_unique=False)).sum())
    missed = int((~np.isin(genome_kmers, distinct,
                           assume_unique=True)).sum())
    return {"asm_err_ppm": 1e6 * absent / max(n, 1),
            "genome_miss_pct": 100.0 * missed / max(len(genome_kmers), 1)}


def banded_cost(q, q_len, t, t_len, offset, band: int):
    """Minimal glocal edit cost [B] (unit costs; BIG when no path lies in
    the band): query i sits near target column i + offset, the target's
    ends are free. Codes compare as they are (4 matches 4)."""
    q, t = np.asarray(q, np.int64), np.asarray(t, np.int64)
    B, Lq = q.shape
    Lt = t.shape[1]
    K = 2 * band + 1
    ks = np.arange(K)[None, :]
    offs = np.asarray(offset, np.int64)[:, None]
    tl = np.asarray(t_len, np.int64)[:, None]
    ql = np.asarray(q_len, np.int64)[:, None]
    j0 = offs - band + ks
    row = np.where((j0 >= 0) & (j0 <= tl), 0, BIG)
    result = row
    for i in range(Lq):
        r = i + 1
        j = r + offs - band + ks
        in_t = (j >= 1) & (j <= tl)
        tb = np.take_along_axis(t, np.clip(j - 1, 0, Lt - 1), axis=1)
        sub = (tb != q[:, i:i + 1]).astype(np.int64)
        up = np.concatenate([row[:, 1:], np.full((B, 1), BIG)], 1) + 1
        m = np.minimum(row + sub, up)
        m = np.where(in_t, m, BIG)
        m = np.where(j == 0, r, m)
        run = np.minimum.accumulate(m - ks, axis=1)
        new = np.minimum(m, run + ks)
        row = np.minimum(np.where(in_t | (j == 0), new, BIG), BIG)
        result = np.where(ql == r, row, result)
    jf = ql + offs - band + ks
    return np.where((jf >= 0) & (jf <= tl), result, BIG).min(axis=1)


def placement_errors(codes, lengths, contig, anchor, is_rc, mismatches,
                     bases, offsets, max_mismatch_frac: float = 0.06,
                     band: int = 8) -> dict:
    """Judges stated placements of reads on contigs (the rule of the
    assembler's read aligner, ALLPATHS-LG's QueryLookupTable with a banded
    rescue). A read on contig c, anchored at a, forward: base j faces
    contig position a + j; reverse: a - j, complemented. Its gap-free
    count is the mismatches over bases that face the contig. When at
    least 90 % of the read faces the contig and the count is at most
    floor(float32(frac) * float32(len)), the stated mismatches must equal
    it; otherwise they must equal the banded edit cost of the oriented
    read against the contig window it expects, +- band, and be within
    that same limit. Returns {n, bad}."""
    codes = np.asarray(codes, np.int64)
    N, L = codes.shape
    lengths = np.asarray(lengths, np.int64)
    offsets = np.asarray(offsets, np.int64)
    flat = np.asarray(bases, np.int64)
    gstart, cend = offsets[contig], offsets[np.asarray(contig) + 1]
    j = np.arange(L)[None, :]
    rc = np.asarray(is_rc, bool)[:, None]
    a = np.asarray(anchor, np.int64)[:, None]
    tpos = np.where(rc, a - j, a + j) + gstart[:, None]
    inb = ((tpos >= gstart[:, None]) & (tpos < cend[:, None])
           & (j < lengths[:, None]))
    tb = flat[np.clip(tpos, 0, len(flat) - 1)]
    tb = np.where(rc, 3 - tb, tb)
    is_base = codes < 4
    mm = ((codes != tb) & inb & is_base).sum(1)
    n_in = (inb & is_base).sum(1)
    limit = (np.float32(max_mismatch_frac)
             * lengths.astype(np.float32)).astype(np.int64)
    gap_free = (n_in >= (lengths * 9) // 10) & (mm <= limit)
    # the rescue's problem: the oriented read against [start - band,
    # start + L + band) of its contig, start its expected first column
    jj = np.clip(lengths[:, None] - 1 - j, 0, L - 1)
    rq = np.take_along_axis(codes, jj, axis=1)
    rq = np.where((rq < 4) & (j < lengths[:, None]), 3 - rq, 4)
    q = np.where(rc, rq, codes)
    exp = np.where(rc[:, 0], a[:, 0] - (lengths - 1), a[:, 0])
    tp = (gstart + exp - band)[:, None] + np.arange(L + 2 * band)[None, :]
    t = np.where((tp >= gstart[:, None]) & (tp < cend[:, None]),
                 flat[np.clip(tp, 0, len(flat) - 1)], 4)
    cost = banded_cost(q, lengths, t, np.full(N, L + 2 * band),
                       np.full(N, band), band)
    stated = np.asarray(mismatches, np.int64)
    ok = np.where(gap_free, stated == mm, (stated == cost) & (cost <= limit))
    return {"n": int(N), "bad": int((~ok).sum())}


def unplaced_pct(n_reads: int, aligned, n_pairs: int) -> float:
    """The share of the fragment reads handed to the aligner that it left
    unplaced, in %. Each of the library's `n_pairs` simulated pairs goes
    to the aligner as one filled read or as its two mates, so it gets
    from n_pairs to 2 n_pairs reads and states a flag for each; a read
    count outside that range, or a flag missing or extra, reads 100."""
    aligned = np.asarray(aligned, bool)
    if not n_pairs <= n_reads <= 2 * n_pairs or len(aligned) != n_reads:
        return 100.0
    return 100.0 * (n_reads - int(aligned.sum())) / n_reads


def imported_pair_errors(got: dict, want: dict) -> int:
    """Pairs whose two reads (codes, quals, lengths) differ from the pair
    of the same rank that was written, plus any pair missing or extra."""
    gp, wp = np.asarray(got["pairs"]), np.asarray(want["pairs"])
    n = min(len(gp), len(wp))
    bad = np.zeros(n, bool)
    for mate in (0, 1):
        g, w = gp[:n, mate], wp[:n, mate]
        for key in ("codes", "quals"):
            x, y = np.asarray(got[key])[g], np.asarray(want[key])[w]
            if x.shape != y.shape:
                return max(len(gp), len(wp))
            bad |= (x != y).any(axis=1)
        bad |= np.asarray(got["lengths"])[g] != np.asarray(
            want["lengths"])[w]
    return int(bad.sum()) + abs(len(gp) - len(wp))

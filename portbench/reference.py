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
  genome the benchmark generated (against both haplotypes of a diploid
  one).
- `genome_index`, `unibase_diagonals`, `jump_pairs_lost_pct`: a jump
  library's pairs judged against the genome through the unibases their
  reads were placed on.
"""

from __future__ import annotations

import numpy as np

K_SPECTRUM = 25          # validate_inputs' K
MAX_FREQ = 255           # its spectrum clip
K_ASSEMBLY = 25
SHIFT_BITS = 36          # a diagonal's shift, offset to be >= 0, in a key
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


def _flat_kmers(bases: np.ndarray, offsets: np.ndarray, K: int):
    """(forward K-mers, their reverse complements, which windows are valid)
    at every start of a flat sequence set (bases uint8, offsets int64
    [n + 1]): a window is valid when it lies inside one sequence and
    holds no code >= 4 (N, gap)."""
    b = np.asarray(bases, np.uint8)
    offsets = np.asarray(offsets, np.int64)
    M = len(b) - K + 1
    if M <= 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, np.zeros(0, bool)
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
    return fwd, rev, valid


def kmer_set(bases: np.ndarray, offsets: np.ndarray, K: int = K_ASSEMBLY):
    """(sorted distinct canonical K-mers, every valid window's K-mer, the
    count of valid windows) of a flat sequence set (bases uint8, offsets
    int64 [n + 1]): windows that lie inside one sequence and hold no code
    >= 4 (N, gap)."""
    fwd, rev, valid = _flat_kmers(bases, offsets, K)
    flat = np.minimum(fwd, rev)[valid]
    return np.unique(flat), flat, len(flat)


def assembly_vs_genome(bases, offsets, genome_kmers: np.ndarray,
                       shared_kmers: np.ndarray = None) -> dict:
    """asm_err_ppm: the assembly's 25-mer windows absent from the genome,
    per million windows; genome_miss_pct: the genome's distinct 25-mers
    absent from the assembly, in %. For a diploid genome `genome_kmers`
    is the union of the haplotypes' and `shared_kmers` their
    intersection, over which the misses are taken."""
    if shared_kmers is None:
        shared_kmers = genome_kmers
    distinct, flat, n = kmer_set(bases, offsets)
    absent = int((~np.isin(flat, genome_kmers, assume_unique=False)).sum())
    missed = int((~np.isin(shared_kmers, distinct,
                           assume_unique=True)).sum())
    return {"asm_err_ppm": 1e6 * absent / max(n, 1),
            "genome_miss_pct": 100.0 * missed / max(len(shared_kmers), 1)}


def haplotype_kmers(haplotypes: list) -> tuple:
    """(union, intersection) of the haplotypes' distinct canonical 25-mers;
    a haploid genome's own set twice."""
    sets = [kmer_set(h, np.array([0, len(h)]))[0] for h in haplotypes]
    union, shared = sets[0], sets[0]
    for k in sets[1:]:
        union = np.union1d(union, k)
        shared = np.intersect1d(shared, k, assume_unique=True)
    return union, shared


def genome_index(haplotypes: list, K: int = K_ASSEMBLY) -> tuple:
    """(sorted forward K-mers, the genome position of each) over every
    haplotype. The haplotypes share coordinates (they differ by
    substitutions only), so a K-mer at one place in two appears once."""
    keys, pos = [], []
    for h in haplotypes:
        fwd, _, valid = _flat_kmers(h, np.array([0, len(h)]), K)
        at = np.flatnonzero(valid)
        keys.append(fwd[at])
        pos.append(at)
    keys, pos = np.concatenate(keys), np.concatenate(pos)
    order = np.lexsort((pos, keys))
    keys, pos = keys[order], pos[order]
    first = np.ones(len(keys), bool)
    first[1:] = (keys[1:] != keys[:-1]) | (pos[1:] != pos[:-1])
    return keys[first], pos[first]


def unibase_diagonals(bases, offsets, index: tuple,
                      K: int = K_ASSEMBLY) -> tuple:
    """Each unibase's placements on the genome, as arrays (unibase, shift,
    strand) sorted by unibase. Strand +1: unibase position x lies at
    genome position shift + x; strand -1: at shift - x, complemented. A
    placement is a diagonal on which at least half of the unibase's
    valid K-mers land, so a repeat unibase has one for each copy."""
    offsets = np.asarray(offsets, np.int64)
    fwd, rev, valid = _flat_kmers(bases, offsets, K)
    at = np.flatnonzero(valid)
    uni = np.searchsorted(offsets, at, side="right") - 1
    x = at - offsets[uni]
    n_valid = np.bincount(uni, minlength=len(offsets) - 1)
    keys, gpos = index
    got = []
    for strand, q in ((1, fwd[at]), (-1, rev[at])):
        lo = np.searchsorted(keys, q, "left")
        n = np.searchsorted(keys, q, "right") - lo
        w = np.repeat(np.arange(len(q)), n)
        g = gpos[np.repeat(lo - np.cumsum(n) + n, n) + np.arange(n.sum())]
        # a reverse hit at genome g holds unibase bases x .. x + K - 1
        # complemented at g + K - 1 .. g
        shift = g - x[w] if strand == 1 else g + x[w] + K - 1
        # one key a (unibase, strand, shift), in that order
        got.append(((2 * uni[w] + (strand == -1)) << SHIFT_BITS)
                   + shift + (1 << (SHIFT_BITS - 1)))
    diag, votes = np.unique(np.concatenate(got), return_counts=True)
    u = diag >> SHIFT_BITS
    keep = 2 * votes >= n_valid[u >> 1]
    diag, u = diag[keep], u[keep]
    return (u >> 1, (diag & ((1 << SHIFT_BITS) - 1)) - (1 << (SHIFT_BITS - 1)),
            1 - 2 * (u & 1))


def read_mismatches(codes, lengths, contig, anchor, is_rc, bases,
                    offsets, rows_a_block: int = 1 << 16) -> tuple:
    """(gap-free mismatches, bases that face the contig) of each read at
    its stated placement on contigs (bases, offsets): forward from anchor
    a, base j faces contig position a + j; reverse, a - j, complemented.
    Only bases (codes < 4) inside the read that face the contig count."""
    flat = np.asarray(bases, np.int64)
    offsets = np.asarray(offsets, np.int64)
    mm = np.zeros(len(lengths), np.int64)
    n_in = np.zeros(len(lengths), np.int64)
    L = np.asarray(codes).shape[1]
    j = np.arange(L)[None, :]
    for s in range(0, len(lengths), rows_a_block):
        e = s + rows_a_block
        c = np.asarray(codes[s:e], np.int64)
        ln = np.asarray(lengths[s:e], np.int64)[:, None]
        rc = np.asarray(is_rc[s:e], bool)[:, None]
        a = np.asarray(anchor[s:e], np.int64)[:, None]
        u = np.asarray(contig[s:e], np.int64)
        start, end = offsets[u][:, None], offsets[u + 1][:, None]
        tpos = np.where(rc, a - j, a + j) + start
        tb = flat[np.clip(tpos, 0, max(len(flat) - 1, 0))]
        tb = np.where(rc, 3 - tb, tb)
        faces = (tpos >= start) & (tpos < end) & (j < ln) & (c < 4)
        mm[s:e] = ((c != tb) & faces).sum(1)
        n_in[s:e] = faces.sum(1)
    return mm, n_in


def jump_pairs_lost_pct(n_written: int, reads: dict, unibases: dict,
                        diagonals: tuple, insert: int, sd: int) -> float:
    """The share of a jump library's pairs, in %, not placed as a valid
    pair. `reads` holds the library as jump_ec left it (codes, lengths,
    pairs, pair_ok) and its alignlets (contig, anchor, is_rc, aligned);
    `unibases` the unibases they name (bases, offsets). A read is placed
    when it is aligned with a length above 0, lies inside its unibase
    (forward from anchor a: a .. a + len - 1; reverse: a - len + 1 .. a)
    and differs there from the unibase in at most a tenth of its bases
    (gap-free); it takes a genome interval and strand on each diagonal
    of its unibase. A pair is valid when `pair_ok` holds, both mates are
    placed, and some choice of their diagonals puts them on opposite
    strands, facing each other (innie, as jump_ec leaves them), with the
    span from outer end to outer end within insert +- 4 sd. A library
    whose pair count is not the `n_written` pairs handed over reads
    100."""
    pairs = np.asarray(reads["pairs"], np.int64).reshape(-1, 2)
    if len(pairs) != n_written:
        return 100.0
    ln = np.asarray(reads["lengths"], np.int64)
    c = np.asarray(reads["contig"], np.int64)
    a = np.asarray(reads["anchor"], np.int64)
    rc = np.asarray(reads["is_rc"], bool)
    uoff = np.asarray(unibases["offsets"], np.int64)
    n_uni = len(uoff) - 1
    lo = np.where(rc, a - ln + 1, a)
    hi = lo + ln - 1
    inside = ((c >= 0) & (c < n_uni) & (lo >= 0)
              & (hi < np.diff(uoff)[np.clip(c, 0, max(n_uni - 1, 0))]
                 if n_uni else np.zeros(len(c), bool)))
    placed = np.asarray(reads["aligned"], bool) & (ln > 0) & inside
    at = np.flatnonzero(placed)
    mm, _ = read_mismatches(np.asarray(reads["codes"])[at], ln[at], c[at],
                            a[at], rc[at], unibases["bases"], uoff)
    placed[at] = 10 * mm <= ln[at]
    d_uni, d_shift, d_strand = diagonals
    first = np.searchsorted(d_uni, c, "left")
    n_diag = np.where(placed, np.searchsorted(d_uni, c, "right") - first, 0)
    # every placement of every read: (read, genome start, end, strand)
    read = np.repeat(np.arange(len(ln)), n_diag)
    k = (np.repeat(first - np.cumsum(n_diag) + n_diag, n_diag)
         + np.arange(n_diag.sum()))
    sh, st = d_shift[k], d_strand[k]
    g_lo = np.where(st == 1, sh + lo[read], sh - hi[read])
    g_hi = np.where(st == 1, sh + hi[read], sh - lo[read])
    g_fwd = (st == 1) != rc[read]
    p_first = np.zeros(len(ln) + 1, np.int64)
    np.cumsum(n_diag, out=p_first[1:])
    # every choice of one placement a mate, for pairs kept with both
    # mates placed
    m0, m1 = pairs[:, 0], pairs[:, 1]
    n0, n1 = n_diag[m0], n_diag[m1]
    n_pick = np.where(np.asarray(reads["pair_ok"], bool), n0 * n1, 0)
    pair = np.repeat(np.arange(len(pairs)), n_pick)
    j = np.arange(n_pick.sum()) - np.repeat(np.cumsum(n_pick) - n_pick,
                                            n_pick)
    i0 = p_first[m0[pair]] + j // n1[pair]
    i1 = p_first[m1[pair]] + j % n1[pair]
    opposite = g_fwd[i0] != g_fwd[i1]
    left = np.where(g_fwd[i0], g_lo[i0], g_lo[i1])
    right = np.where(g_fwd[i0], g_hi[i1], g_hi[i0])
    span = right - left + 1
    good = opposite & (np.abs(span - insert) <= 4 * sd)
    valid = np.zeros(len(pairs), bool)
    valid[pair[good]] = True
    return 100.0 * (n_written - int(valid.sum())) / max(n_written, 1)


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
    mm, n_in = read_mismatches(codes, lengths, contig, anchor, is_rc,
                               bases, offsets)
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

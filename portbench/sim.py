"""The benchmark's own read and genome simulator (numpy only).

Frozen copies, so that a change to the program cannot change the inputs:
- `random_genome`, `simulate_paired_reads`: allpathslg_tpu_torch/eval/sim.py
  (the same numpy draws in the same order, so the same reads);
- `mutate_genome`: eval/sim.py's (the control's strain);
- `repeat_genome`: chip_smoke.py's, with the families and GC as arguments;
- `simulate_long_reads`: eval/sim.py's model (exponential lengths clipped
  to [min_len, 4 * mean_len], errors 50 % insertions, 30 % deletions, 20 %
  substitutions), vectorised: eval/sim.py draws base by base in Python.
"""

from __future__ import annotations

import numpy as np


def random_genome(length: int, seed: int, gc: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p_at, p_gc = (1 - gc) / 2, gc / 2
    return rng.choice(4, size=length,
                      p=[p_at, p_gc, p_gc, p_at]).astype(np.uint8)


def mutate_genome(genome: np.ndarray, snp_rate: float, seed: int):
    """A strain of `genome`: each base changed with probability snp_rate
    (eval/sim.mutate_genome's draws)."""
    rng = np.random.default_rng(seed)
    g = genome.copy()
    snps = rng.random(len(g)) < snp_rate
    g[snps] = (g[snps] + rng.integers(1, 4, snps.sum())) % 4
    return g


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1].copy()


def repeat_genome(size: int, seed: int, gc: float, families) -> np.ndarray:
    """A random genome carrying repeat `families` [(length, copies)]: the
    copies are spread one per slot of size / n_copies, each at a random
    place in its slot; a family's later copies repeat its first, forward
    or reverse-complemented."""
    g = random_genome(size, seed, gc)
    rng = np.random.default_rng(seed + 1000)
    copies = [(fi, n) for fi, (n, c) in enumerate(families)
              for _ in range(c)]
    slot = size // len(copies)
    src = {}
    for s, ci in enumerate(rng.permutation(len(copies))):
        fi, n = copies[ci]
        at = s * slot + int(rng.integers(0, slot - n))
        if fi not in src:
            src[fi] = g[at:at + n].copy()
            continue
        seg = src[fi]
        if rng.random() < 0.5:
            seg = revcomp(seg)
        g[at:at + n] = seg
    return g


def simulate_paired_reads(genome: np.ndarray, coverage: float, read_len: int,
                          insert_mean: int, insert_sd: int,
                          error_rate: float, outward: bool, seed: int) -> dict:
    """A paired library: {codes uint8 [N, L], quals uint8 [N, L], lengths
    int32 [N], pairs int32 [P, 2]}. Innie pairs read toward each other
    across the insert; outward (raw jump) pairs are both flipped.
    Qualities fall from ~Q38 toward ~Q20 over the 3' half; errors are
    substitutions drawn per base with a probability scaled by quality and
    normalised to `error_rate`."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    n_pairs = max(1, int(coverage * G / (2 * read_len)))
    inserts = rng.normal(insert_mean, insert_sd, n_pairs).astype(np.int64)
    inserts = np.maximum(inserts, read_len)
    max_start = G - inserts
    starts = (rng.random(n_pairs) * np.maximum(max_start, 1)).astype(np.int64)
    n_reads = 2 * n_pairs
    codes = np.empty((n_reads, read_len), dtype=np.uint8)
    j = np.arange(read_len, dtype=np.int64)[None, :]
    fwd = genome[starts[:, None] + j]
    rev = 3 - genome[(starts + inserts - 1)[:, None] - j]
    if not outward:
        codes[0::2], codes[1::2] = fwd, rev
    else:
        codes[0::2] = (3 - fwd)[:, ::-1]
        codes[1::2] = (3 - rev)[:, ::-1]
    pos = np.arange(read_len)
    qprof = np.clip(38 - 18 * np.maximum(0, pos - read_len // 2)
                    / max(1, read_len // 2), 2, 40)
    quals = np.broadcast_to(qprof, (n_reads, read_len)).astype(np.uint8)
    quals = np.clip(quals + rng.integers(-3, 4, quals.shape), 2,
                    41).astype(np.uint8)
    perr = error_rate * (10.0 ** ((30.0 - quals.astype(np.float64))
                                  / 10.0)) ** 0.5
    if error_rate > 0:
        perr = np.clip(perr * (error_rate / perr.mean()), 0, 0.25)
    err = rng.random(codes.shape) < perr
    shift = rng.integers(1, 4, codes.shape).astype(np.uint8)
    codes = np.where(err, (codes + shift) % 4, codes).astype(np.uint8)
    pairs = np.stack([np.arange(0, n_reads, 2), np.arange(1, n_reads, 2)],
                     axis=1).astype(np.int32)
    return {"codes": codes, "quals": quals,
            "lengths": np.full(n_reads, read_len, np.int32), "pairs": pairs}


def simulate_long_reads(genome: np.ndarray, coverage: float, mean_len: int,
                        min_len: int, error_rate: float, seed: int) -> dict:
    """PacBio CLR-like reads as {bases uint8 [total], offsets int64 [n + 1]}.
    Before each template base come k random inserted bases, P(k) =
    p_ins**k (1 - p_ins) with p_ins = error_rate / 2; the base itself is
    then deleted with probability 0.3 error_rate / (1 - p_ins), substituted
    with 0.2 error_rate / (1 - p_ins), else copied: the per-draw rates of
    eval/sim.py's loop."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    n = max(1, int(coverage * G / mean_len))
    lens = np.clip(rng.exponential(mean_len, n), min_len,
                   4 * mean_len).astype(np.int64)
    lens = np.minimum(lens, G - 1)
    starts = (rng.random(n) * (G - lens)).astype(np.int64)
    rcs = rng.integers(0, 2, n).astype(bool)
    p_ins = error_rate * 0.5
    p_del = error_rate * 0.3 / (1 - p_ins)
    p_sub = error_rate * 0.2 / (1 - p_ins)
    reads = []
    for s, L, rc in zip(starts, lens, rcs):
        seq = genome[s:s + L]
        if rc:
            seq = revcomp(seq)
        n_ins = rng.geometric(1 - p_ins, L) - 1
        u = rng.random(L)
        keep = (u >= p_del).astype(np.int64)
        sub = (u >= p_del) & (u < p_del + p_sub)
        base = np.where(sub, (seq + rng.integers(1, 4, L)) % 4, seq)
        out = rng.integers(0, 4, int(n_ins.sum() + keep.sum())).astype(
            np.uint8)
        at = np.cumsum(n_ins + keep) - 1     # each kept base comes last
        out[at[keep == 1]] = base[keep == 1]
        reads.append(out)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offsets[1:])
    return {"bases": np.concatenate(reads).astype(np.uint8),
            "offsets": offsets}

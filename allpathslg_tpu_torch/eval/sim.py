"""Read/genome simulator — the test+eval oracle harness (port of
allpathslg_tpu/eval/sim.py: host numpy; it draws the same numpy random
numbers in the same order, so the reads are byte-identical).

The reference relies on simulated inputs with known truth for evaluation
(ref: src/paths/simulation/, MutateReference, EVALUATION=CHEAT modes).
Here the simulator is foundational: every stage's unit/integration test
assembles simulated data and checks against the known genome.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from allpathslg_tpu_torch.dtypes.reads import (PairTable, ReadBatch,
                                               batch_from_codes)


@dataclasses.dataclass
class SimTruth:
    genome: np.ndarray              # uint8 codes [G]
    read_starts: np.ndarray         # int32 [N] position of read on genome
    read_rc: np.ndarray             # bool [N] read is reverse strand
    error_mask: np.ndarray          # bool [N, L] simulated sequencing errors


def random_genome(length: int, seed: int = 0, gc: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p_at = (1 - gc) / 2
    p_gc = gc / 2
    return rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at]).astype(np.uint8)


def mutate_genome(genome: np.ndarray, snp_rate: float, seed: int = 1) -> np.ndarray:
    """Create a diverged haplotype (ref: MutateReference)."""
    rng = np.random.default_rng(seed)
    g = genome.copy()
    snps = rng.random(len(g)) < snp_rate
    g[snps] = (g[snps] + rng.integers(1, 4, snps.sum())) % 4
    return g


def _rc(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1].copy()


def simulate_long_reads(
    genome: np.ndarray,
    coverage: float = 10.0,
    mean_len: int = 8000,
    min_len: int = 1000,
    error_rate: float = 0.12,
    seed: int = 9,
):
    """Noisy long reads (PacBio CLR-like): exponential lengths, errors split
    ~ 50% ins / 30% del / 20% sub (ref long-read patching inputs,
    Ribeiro 2012 workflow). Returns (list of code arrays, starts, rc)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    n = max(1, int(coverage * G / mean_len))
    reads, starts, rcs = [], [], []
    for _ in range(n):
        L = int(np.clip(rng.exponential(mean_len), min_len, 4 * mean_len))
        L = min(L, G - 1)
        s = int(rng.integers(0, G - L))
        seq = genome[s : s + L].copy()
        rc = bool(rng.integers(0, 2))
        if rc:
            seq = _rc(seq)
        # inject errors
        out = []
        i = 0
        while i < len(seq):
            r = rng.random()
            if r < error_rate * 0.5:          # insertion
                out.append(rng.integers(0, 4))
                continue
            if r < error_rate * 0.8:          # deletion
                i += 1
                continue
            if r < error_rate:                # substitution
                out.append((seq[i] + rng.integers(1, 4)) % 4)
            else:
                out.append(seq[i])
            i += 1
        reads.append(np.asarray(out, np.uint8))
        starts.append(s)
        rcs.append(rc)
    return reads, np.asarray(starts), np.asarray(rcs)


def simulate_paired_reads(
    genome: np.ndarray,
    coverage: float = 50.0,
    read_len: int = 100,
    insert_mean: int = 180,
    insert_sd: int = 18,
    error_rate: float = 0.005,
    outward: bool = False,
    seed: int = 2,
    circular: bool = False,
) -> Tuple[ReadBatch, PairTable, SimTruth]:
    """Simulate a paired library (fragment if insert≈180, jump if larger).

    Pair geometry follows the reference's conventions (ref: manual +
    src/PairsManager.h): innie pairs read toward each other across the
    insert; jump libraries start outward-facing ("outies") before EC flips
    them. Qualities follow a declining 3' profile; errors are drawn per base
    with probability scaled by quality.
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    n_pairs = max(1, int(coverage * G / (2 * read_len)))
    inserts = rng.normal(insert_mean, insert_sd, n_pairs).astype(np.int64)
    inserts = np.maximum(inserts, read_len)
    max_start = G - inserts if not circular else np.full(n_pairs, G)
    starts = (rng.random(n_pairs) * np.maximum(max_start, 1)).astype(np.int64)

    n_reads = 2 * n_pairs
    codes = np.empty((n_reads, read_len), dtype=np.uint8)
    read_starts = np.empty(n_reads, dtype=np.int32)
    read_rc = np.empty(n_reads, dtype=bool)

    gext = np.concatenate([genome, genome[: read_len + 1]]) if circular else genome
    j = np.arange(read_len, dtype=np.int64)[None, :]
    fwd = gext[starts[:, None] + j]                                # [P, L]
    # rev = rc of gext[s+ins-L : s+ins]: base j = 3 - gext[s+ins-1-j]
    rev = 3 - gext[(starts + inserts - 1)[:, None] - j]
    if not outward:  # innie: r1 fwd at s, r2 rc at end of insert
        codes[0::2] = fwd
        codes[1::2] = rev
        read_rc[0::2], read_rc[1::2] = False, True
    else:  # outie (raw jump): both flipped
        codes[0::2] = (3 - fwd)[:, ::-1]
        codes[1::2] = (3 - rev)[:, ::-1]
        read_rc[0::2], read_rc[1::2] = True, False
    read_starts[0::2] = starts
    read_starts[1::2] = starts + inserts - read_len

    # qualities: plateau at q38 dropping toward 3' end to ~q20
    pos = np.arange(read_len)
    qprof = np.clip(38 - 18 * np.maximum(0, pos - read_len // 2) / max(1, read_len // 2), 2, 40)
    quals = np.broadcast_to(qprof, (n_reads, read_len)).astype(np.uint8).copy()
    quals = np.clip(quals + rng.integers(-3, 4, quals.shape), 2, 41).astype(np.uint8)

    perr = error_rate * (10.0 ** ((30.0 - quals.astype(np.float64)) / 10.0)) ** 0.5
    if error_rate > 0:
        perr = np.clip(perr * (error_rate / perr.mean()), 0, 0.25)
    err = rng.random(codes.shape) < perr
    shift = rng.integers(1, 4, codes.shape).astype(np.uint8)
    codes = np.where(err, (codes + shift) % 4, codes).astype(np.uint8)

    lengths = np.full(n_reads, read_len, dtype=np.int32)
    batch = batch_from_codes(codes, lengths, quals)
    pair_idx = np.stack([np.arange(0, n_reads, 2), np.arange(1, n_reads, 2)], axis=1)
    pairs = PairTable(
        pairs=pair_idx.astype(np.int32),
        lib_ids=np.zeros(n_pairs, dtype=np.int8),
        lib_sep=np.asarray([insert_mean], dtype=np.int32),
        lib_sd=np.asarray([insert_sd], dtype=np.int32),
    )
    truth = SimTruth(genome=genome, read_starts=read_starts,
                     read_rc=read_rc, error_mask=err)
    return batch, pairs, truth

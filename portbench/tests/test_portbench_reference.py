"""The plain reference and the frozen copies, at small sizes on the CPU."""

import collections

import numpy as np
import torch

from portbench import reference as ref
from portbench import sim


def brute_spectrum(codes, lengths, K, max_freq=255):
    counts = collections.Counter()
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    for row, n in zip(codes, lengths):
        for p in range(n - K + 1):
            w = tuple(int(x) for x in row[p:p + K])
            if max(w) >= 4:
                continue
            rc = tuple(comp[x] for x in reversed(w))
            counts[min(w, rc)] += 1
    spec = np.zeros(max_freq + 1, np.int64)
    for c in counts.values():
        spec[min(c, max_freq)] += 1
    return spec


def test_spectrum_matches_a_brute_count():
    rng = np.random.default_rng(3)
    genome = sim.random_genome(600, seed=4)
    starts = rng.integers(0, 560, 300)
    codes = genome[starts[:, None] + np.arange(40)[None, :]].copy()
    codes[rng.random(codes.shape) < 0.01] = 4
    lengths = rng.integers(20, 41, 300).astype(np.int32)
    for K in (5, 25):
        want = brute_spectrum(codes, lengths, K, max_freq=6)
        got = ref.spectrum(codes, lengths, K=K, max_freq=6)
        assert np.array_equal(got, want)


def test_banded_cost_is_the_ports_plain_dp():
    from allpathslg_tpu_torch.ops.banded import banded_align

    rng = np.random.default_rng(5)
    B, Lq, Lt = 64, 30, 46
    for band in (0, 3, 8):
        q = rng.integers(0, 5, (B, Lq)).astype(np.uint8)
        t = rng.integers(0, 5, (B, Lt)).astype(np.uint8)
        t[:, 8:8 + Lq] = np.where(rng.random((B, Lq)) < 0.8, q, t[:, 8:38])
        ql = rng.integers(0, Lq + 1, B).astype(np.int32)
        tl = rng.integers(0, Lt + 1, B).astype(np.int32)
        off = rng.integers(-4, 20, B).astype(np.int32)
        want, _ = banded_align(*(torch.from_numpy(x) for x in
                                 (q, ql, t, tl, off)), band=band)
        got = ref.banded_cost(q, ql, t, tl, off, band)
        assert np.array_equal(got, want.numpy())


def placed_reads(rng, contigs_flat, offsets, n, L, rc_share=0.5):
    """n reads of L bases cut from the contigs, some reverse-complemented,
    with their (contig, anchor, is_rc)."""
    c = rng.integers(0, len(offsets) - 1, n)
    lens = np.diff(offsets)[c]
    start = rng.integers(0, lens - L)
    rc = rng.random(n) < rc_share
    j = np.arange(L)[None, :]
    seq = contigs_flat[(offsets[c] + start)[:, None] + j]
    codes = np.where(rc[:, None], (3 - seq)[:, ::-1], seq).astype(np.uint8)
    anchor = np.where(rc, start + L - 1, start)
    return codes, c, anchor, rc


def test_placement_errors_judge_stated_mismatches():
    rng = np.random.default_rng(7)
    flat = sim.random_genome(3000, seed=8)
    offsets = np.array([0, 1000, 2200, 3000])
    codes, c, a, rc = placed_reads(rng, flat, offsets, 200, 101)
    codes[:20, 50] = (codes[:20, 50] + 1) % 4        # one mismatch each
    # reads 20-29: an insertion at base 40, which the gap-free rule fails
    ins = codes[20:30].copy()
    codes[20:30, 41:] = ins[:, 40:-1]
    codes[20:30, 40] = (ins[:, 40] + 2) % 4
    lengths = np.full(200, 101, np.int32)
    mm = np.zeros(200, np.int64)
    mm[:20] = 1
    mm[20:30] = 1                                    # their edit cost
    got = ref.placement_errors(codes, lengths, c, a, rc, mm, flat, offsets)
    assert got == {"n": 200, "bad": 0}
    mm[5] += 1
    mm[25] += 1
    got = ref.placement_errors(codes, lengths, c, a, rc, mm, flat, offsets)
    assert got["bad"] == 2


def test_assembly_vs_genome():
    g = sim.random_genome(20_000, seed=9)
    gk, _, _ = ref.kmer_set(g, np.array([0, len(g)]))
    parts = np.concatenate([g[:9000], sim.revcomp(g[9000:15000])])
    offs = np.array([0, 9000, 15000])
    got = ref.assembly_vs_genome(parts, offs, gk)
    assert got["asm_err_ppm"] == 0
    assert abs(got["genome_miss_pct"] - 100 * 5024 / 19976) < 0.2
    strain = sim.mutate_genome(g, 0.003, seed=1)
    got = ref.assembly_vs_genome(strain, np.array([0, len(g)]), gk)
    assert got["asm_err_ppm"] > 50_000 and got["genome_miss_pct"] > 5


def test_simulator_copy_draws_the_ports_reads():
    from allpathslg_tpu_torch.eval import sim as port_sim

    g = sim.random_genome(30_000, seed=11, gc=0.688)
    assert np.array_equal(g, port_sim.random_genome(30_000, seed=11,
                                                    gc=0.688))
    for outward, ins in ((False, 180), (True, 3500)):
        mine = sim.simulate_paired_reads(g, 20.0, 101, ins, ins // 10,
                                         0.01, outward, 12)
        b, p, _ = port_sim.simulate_paired_reads(
            g, coverage=20.0, read_len=101, insert_mean=ins,
            insert_sd=ins // 10, error_rate=0.01, outward=outward, seed=12)
        assert np.array_equal(mine["codes"], b.codes)
        assert np.array_equal(mine["quals"], b.quals)
        assert np.array_equal(mine["pairs"], p.pairs)


def test_long_reads_follow_the_model():
    g = sim.random_genome(200_000, seed=13)
    lr = sim.simulate_long_reads(g, 10.0, 8000, 1000, 0.12, seed=14)
    lens = np.diff(lr["offsets"])
    assert len(lens) == 250
    # templates of 1-32 kb; insertions add ~6.4 %, deletions take ~3.8 %
    assert lens.min() >= 900 and lens.max() <= 34_000
    assert 5_000 < lens.mean() < 11_000


def test_unplaced_pct_counts_reads_the_aligner_left():
    ok = np.array([True] * 90 + [False] * 10)
    assert ref.unplaced_pct(100, ok, n_pairs=60) == 10.0
    # a read count that no fill of 60 pairs can give, or flags missing
    assert ref.unplaced_pct(100, ok, n_pairs=40) == 100.0
    assert ref.unplaced_pct(101, ok, n_pairs=60) == 100.0

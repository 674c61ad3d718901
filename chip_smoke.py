#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (allpathslg_tpu_torch).

    python3 chip_smoke.py [--genome-size N] [--full-genome-size N]
                          [--diploid-genome-size N] [--seed S]

Needs one CUDA GPU (it raises without one) and `nvcc`; it imports nothing
of JAX or of the JAX package. Phases, each printed as it ends:

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the three Hopper kernels, the radix sort (csrc/radix_sort.cu),
     the bit-parallel banded DP (csrc/banded_bp.cu) and the general
     banded DP (csrc/banded_general.cu), and the chain probes
     (csrc/chain_probe.cu), with nvcc for sm_90a, one nvcc for each,
     started together; then chain_terms: the latency of one dependent DPX
     instruction and the device time of an empty launch, which the general
     kernel's chain bound uses;
  3. sort parity on the card at the flagship's shape (131,072 reads x
     150 bp at K=24: 16,646,144 two-word keys): the kernel against its
     plain PyTorch version, exactly, with many duplicate keys and with
     sentinels; keys of one and three words and an int32 payload through
     ops/sort.sort_by_words against the same call on the CPU (where it
     takes the plain version); the adversarial keys of SORT_CASES at 2**20
     keys and at 1 key (histogram kernel against its plain version, the
     passes planned, the sort), and 0 keys; then at 16,646,144, 5,046,272
     (one count_reads batch of 65,536 x 100 bp) and 65,536 keys, the
     passes planned, the bytes moved against the LSD floor, and median
     times in turns of plain version, kernel and torch.sort;
  4. spectrum_step(K=24) on the same batch, against the CPU spectrum;
  5. bit-parallel banded-DP parity on the card: the kernel against the
     plain ops/banded.banded_align, exactly (cost and t_end), at (a) the
     align_frags rescue shape (65,536 x 260 x 276, band 8; reads with
     1-2 indels, ragged lengths, infeasible offsets), (b) bands 1 and 15,
     (c) bench.py's DP shape (16,384 x 100 x 140, band 15) and (d) an
     N-bearing batch (against the plain version on the query with code
     4 -> 6) and (e) consensus-shaped batches (refine_consensus's: B =
     256 with 37 real rows, Lq = Lt = 32, band 6, q_len 20-30, the other
     219 rows q_len = t_len = 0; consensus_problems); kernel (device_ms)
     and plain version (median_ms) timed in turns at (a), (c) and (e);
  6. general banded-DP parity on the card: the kernel against its plain
     version (ops/banded.banded_align), exactly, on GENERAL_SETS: (1)
     bands 16, 24, 48, 96 and 192 at 16,384 x 256 x 512 (ragged, with
     q_len = 0 rows and infeasible offsets), (2) sub_cost=2, gap_cost=3
     at band 24, (3) bench.py's shape (16,384 x 100 x 140, band 15, the
     kernel called directly), (4) an N-bearing batch with no remapping of
     code 4, (5) run_full's three patch_gaps batches, B = 8 (8 x 64 x 512
     at band 192, 8 x 128 x 512 at bands 96 and 48; patch_problems), (6)
     B = 1 at band 16 (assisted's), (7) bands 0, 1, 2, 15 and 255 and (8)
     targets shorter than K with q_len = Lq and offsets at both edges of
     the feasible window (edge_problems) and (9) medoid-shaped batches
     (consensus_patch's all pairs of noisy copies of one gap, lengths
     ragged within +- 12 %, the rest of B rows q_len = t_len = 0; pairs
     further apart than the band have no in-band path: medoid_problems)
     at 128 x 3,072 x 3,072 (121 real rows) bands 192 and 96 and 128 x
     12,000 x 12,000 (16 real rows) band 192; kernel (device_ms) and plain
     version (median_ms) in turns at (1, band 96), (3), (5), (6) and (9),
     each with its bound and the bound's three terms (general_bound);
  7. the contig slice and align_frags through Pipeline(device="cuda"):
     prepare_sim_inputs -> validate_inputs -> remove_dodgy -> precorrect
     -> find_errors -> clean_reads -> fill_fragments -> unipaths ->
     report -> align_frags on a simulated genome (--genome-size, default
     200 kb, 100x fragment coverage, 100 bp reads, 0.5 % error, seed 0,
     batch_reads 65536), with each stage's wall time and kernel launches.
     It checks that the sort kernel ran in validate_inputs, precorrect,
     find_errors and unipaths and the banded kernel in align_frags; that
     the 25-mer genome-size estimate is within 20 % of the truth; that
     corrections were made and the sampled fraction of true 24-mers rises
     from the input reads to the cleaned reads; that the contigs total
     within 5 % of the genome with N50 >= 100 kb (half the genome when
     --genome-size is below 200 kb); that align_frags aligns >= 90 % of
     the filled reads; and that assembly.report names the contig N50;
  8. `Pipeline(device="cuda").run_full()` at the README's binding
     libraries (100x fragment reads of 100 bp at 0.5 % error, 50x jump
     reads of 3000 +- 300, seed 0, batch_reads 65536, stage_workers 2) on
     a genome of --full-genome-size (default 4.6 Mb) carrying repeat
     families like an E. coli chromosome (REPEAT_FAMILIES). It prints each
     stage's wall time from the manifest and each kernel's launches by
     stage, and checks that the general kernel ran, in patch_gaps only;
     that the bit-parallel kernel ran in align_frags and align_jumps; that
     the jump insert estimate is within 10 % of 3000; that patch_gaps
     closed a gap; that the final assembly covers >= 95 % of the genome;
     and that final.assembly.fasta and submission/*.fsa exist. While it
     runs, DPCapture wraps both DP kernels' wrappers and counts their
     calls by (stage, B x Lq x Lt, band) with q_len min / mean / max,
     keeping the first 2 calls of each; after it, every kept call's
     outputs are held against the plain version, exactly, and kernel
     (device_ms) and plain version are timed in turns on the first kept
     align_frags and align_jumps batch of the bit-parallel kernel and on
     each kept batch of the general one, each with its bound (for the
     general kernel, its three terms) and, for the bit-parallel kernel,
     its share of idle lane-rows;
  9. run_full through the port on the card and on the CPU over
     tests/test_torch_full.py's 40 kb genome with a two-copy 2.5 kb
     repeat (40x fragment, 15x jump reads of 4000 +- 350, batch_reads
     4096; cmp_inputs): the general kernel must launch in patch_gaps on
     the card, and every artifact of CMP_ARTIFACTS, every file of
     CMP_TEXT_FILES and every stage metric must be byte-identical;
 9b. the same on tests/test_torch_full_long.py's inputs (long_cmp_inputs:
     the reference's tests/test_repeat_longread_e2e.py 60 kb genome with
     a 2.5 kb repeat, 50x fragment, 15x jump and 12x PacBio reads, plus a
     6x long-jump library of 12000 +- 1200 and an assisting reference of
     0.3 % SNPs; batch_reads 16384): long_jump_scaffolds, long_read_patch
     and assisted run, long_read_patch must launch the general kernel on
     the card, and LONG_ARTIFACTS, CMP_TEXT_FILES and LONG_STAGES' metrics
     must be byte-identical;
 10. `Pipeline(device="cuda").run_full()` over the reference's 500 kb
     diploid multi-library configuration (diploid_inputs, from
     tests/test_scale_diploid_multilib.py; ploidy=2) with haplotype 1 a
     repeat genome of --diploid-genome-size (REPEAT_FAMILIES) and an
     assisting reference, with DPCapture installed: each stage's wall
     time and launches, long_read_patch's host anchoring and DP times
     (StageTimer), and checks that every new stage ran, that the general
     kernel launched in long_read_patch and the bit-parallel one in
     long_jump_scaffolds, that the long jumps kept the scaffold N50, that
     long_read_patch closed a gap and kept > 50 ambiguity records, that
     the genome covered is >= 95 % of what the truth genome covers as an
     assembly (evaluate never covers a repeat copy), and that the final
     FASTA and EFASTA exist; after it, every kept DP call of the new
     stages is held against the plain version, exactly, and timed in
     turns (phase_dp_diploid).

Each phase prints its seconds. Any failed check raises, so the exit code
is not 0. The line before the last is the kernel record {"kernels":
[...]}, whose `launches` are each kernel's launches in the pipeline
phases 7, 8 and 10, each counted from 0 just before its phase, and whose
`bound_ms` is the least time of the
timed call: its bytes (for the DP kernels, those its data needs:
dp_terms) over 3.35 TB/s against its integer operations (BP_OPS_PER_ROW
and GENERAL_OPS_PER_SLOT for the DP kernels) over the card's int32 rate,
and for the general kernel also its chain (general_bound); `bound_by`
names the larger. The bit-parallel kernel's ms, plain_ms and bound_ms
are those of phase 8's align_frags batch (align_jumps_*, set_a_* and
consensus_* keys add its align_jumps batch and sets (a) and (e) of phase
5, long_jump_* and long_read_* phase 10's largest batches of those
stages); the general kernel's are phase 6's set (1, band 96), with b8_*,
b1_band16_*, bench_shape_* and medoid_* keys for sets 5, 6, 3 and 9,
run_full_* lists for phase 8's batches, and long_read_* and assisted_*
lists for phase 10's timed batches of long_read_patch and assisted. The
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FLAGSHIP_READS, FLAGSHIP_LEN, FLAGSHIP_K = 131_072, 150, 24
TIMING_REPS = 10
# Peaks for the bounds (H100 SXM datasheet, at 700 W):
# device memory 3.35 TB/s; int32 operations at 64 lanes a clock on each SM
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def say(*a):
    print(*a, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median time of one fn() call over reps calls, CUDA events around
    each, the card idle before it (so it includes the host's launch time
    where the call's kernels are short)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one fn() call: reps calls enqueued behind a sleep
    kernel that keeps the card busy while the host enqueues them, timed by
    CUDA events around the reps, the median of `rounds`. median_ms times
    one call that starts on an idle card, so a call whose host side (the
    wrapper, the ctypes launch) outlasts its kernel reads as host time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # ~10 ms at 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_card():
    """Prints the card; returns (torch's name for it, its peak int32
    operations a second: SMs x 64 lanes x the largest SM clock)."""
    say(nvidia_smi("name,power.limit"))
    name = torch.cuda.get_device_name(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    say(f"[card] torch device: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {sms} SMs at up to {clock_mhz:.0f} MHz: "
        f"{int_rate / 1e12:.2f} T int32 operations/s")
    return name, int_rate


def dp_terms(q, ql, t, off, band: int, ops_per_row: int, int_rate: float):
    """(bytes ms, operations ms) of a banded-DP call: the bytes this
    batch's data needs (each problem's q_len query bytes and the target
    columns its band reaches, [off - band, q_len + off + band) within [0,
    Lt), read once; q_len, t_len and offset in, cost and t_end out) over
    the memory rate, and the rows its q_len asks for times ops_per_row over
    the int32 rate."""
    Lt = t.shape[1]
    rows = torch.where((ql >= 1) & (ql <= q.shape[1]), ql, 0).to(torch.int64)
    off = off.to(torch.int64)
    lo = (off - band).clamp(0, Lt)
    hi = (rows + off + band).clamp(0, Lt)
    cols = torch.where(rows > 0, (hi - lo).clamp(min=0), 0)
    n_bytes = int(rows.sum()) + int(cols.sum()) + 5 * 4 * q.shape[0]
    return (n_bytes / HBM_BYTES_PER_S * 1e3,
            int(rows.sum()) * ops_per_row / int_rate * 1e3)


def dp_bound(q, ql, t, off, band: int, ops_per_row: int, int_rate: float):
    """(bound ms, "bytes" or "operations"): the larger of dp_terms."""
    by_bytes, by_ops = dp_terms(q, ql, t, off, band, ops_per_row, int_rate)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def general_bound(q, ql, t, off, band: int, int_rate: float, chain: dict):
    """(bound ms, the term that bounds it, {term: ms}) of a general-DP
    call: the largest of its bytes and operations (dp_terms at
    GENERAL_OPS_PER_SLOT a band slot) and its chain, the least dependent
    chain the DP needs, (2 * max q_len + K) dependent instructions at the
    card's measured DPX latency, plus one empty launch (chain_terms)."""
    K = 2 * band + 1
    by_bytes, by_ops = dp_terms(q, ql, t, off, band,
                                K * GENERAL_OPS_PER_SLOT, int_rate)
    rows = torch.where((ql >= 1) & (ql <= q.shape[1]), ql, 0)
    longest = int(rows.max()) if rows.numel() else 0
    by_chain = ((2 * longest + K) * chain["dpx_s"] * 1e3
                + chain["empty_ms"])
    terms = {"bytes": by_bytes, "operations": by_ops, "chain": by_chain}
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def show_terms(terms: dict) -> str:
    return ", ".join(f"{k} {v:.5f}" for k, v in terms.items())


def chain_terms() -> dict:
    """The chain term's two measurements on the card (csrc/chain_probe.cu):
    the latency of one dependent DPX instruction (device_ms of chains of
    4,096 and 65,536 __viaddmin_s32 on one thread, the slope; clock64
    cycles a step beside it) and the device time of one empty launch
    through ctypes (device_ms)."""
    from allpathslg_tpu_torch.ops.cuda import chain_probe

    short, long_ = chain_probe.DpxChain(4096), chain_probe.DpxChain(65536)
    t_short, t_long = device_ms(short), device_ms(long_)
    cycles = long_.cycles_per_step()
    dpx_s = (t_long - t_short) / (long_.n - short.n) * 1e-3
    empty_ms = device_ms(chain_probe.empty)
    say(f"[chain] dependent __viaddmin_s32: {dpx_s * 1e9:.3f} ns a step "
        f"(device_ms of 4,096 and 65,536 steps: {t_short:.5f} / "
        f"{t_long:.5f} ms; clock64 {cycles:.2f} cycles a step); empty "
        f"launch {empty_ms:.5f} ms (device_ms)")
    return {"dpx_s": dpx_s, "dpx_cycles": cycles, "empty_ms": empty_ms}


def phase_build():
    """Build the kernels from the checkout's sources, one nvcc each, all
    started together; then load their libraries."""
    from concurrent.futures import ThreadPoolExecutor

    from allpathslg_tpu_torch.ops.cuda import (banded_cuda,
                                               banded_general_cuda,
                                               chain_probe, sort_cuda)

    mods = (sort_cuda, banded_cuda, banded_general_cuda, chain_probe)
    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(lambda m: m.build(), mods))
    for mod, (path, secs) in zip(mods, built):
        mod.library()
        say(f"[build] {path.name}: nvcc {secs:.2f} s "
            f"({'cached' if secs == 0.0 else 'built from source'})")


def flagship_codes(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (FLAGSHIP_READS, FLAGSHIP_LEN)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 4   # N bases: sentinel keys
    return codes


# Adversarial key sets for the sort, made by adversarial_sort_keys;
# tests/test_torch_sort.py runs the same cases on the CPU
SORT_CASES = ("k24_sentinels", "ff_digits_before_ones", "all_ones",
              "all_equal", "ones_and_one_value", "u32_with_ffffffff",
              "random64")
ONES64 = np.uint64(2**64 - 1)
FF_DIGITS = np.uint64(0xFFFFFFFFFFFF0000)   # a K=24 key of all-T bases


def adversarial_sort_keys(case: str, n: int, seed: int):
    """(uint64 keys [n], key_bits, passes the plan must have) of one case."""
    rng = np.random.default_rng(seed)
    k24 = rng.integers(0, 2**48, n, dtype=np.uint64) << np.uint64(16)
    if case == "k24_sentinels":            # the flagship's keys: 48 bits
        k24[rng.random(n) < 0.002] = ONES64
        return k24, 64, 6
    if case == "ff_digits_before_ones":    # planned digits all 0xFF
        at = 2 * rng.choice(n // 2, min(n // 2, max(1, n // 500)),
                            replace=False)
        k24[at] = FF_DIGITS
        k24[at + 1] = ONES64
        return k24, 64, 6
    if case == "all_ones":
        return np.full(n, ONES64), 64, 0
    if case == "all_equal":
        return np.full(n, np.uint64(0x0123456789ABCDEF)), 64, 0
    if case == "ones_and_one_value":
        u = np.full(n, FF_DIGITS)
        u[rng.random(n) < 0.5] = ONES64
        return u, 64, 1
    if case == "u32_with_ffffffff":
        u = rng.integers(0, 2**32, n, dtype=np.uint64)
        u[rng.random(n) < 0.1] = np.uint64(0xFFFFFFFF)
        return u, 32, 4
    if case == "random64":
        u = rng.integers(0, 2**64, n, dtype=np.uint64)
        u[rng.random(n) < 0.3] = u[:1]                # ties test stability
        return u, 64, 8
    raise ValueError(case)


def batch_keys(n_reads: int, read_len: int, seed: int) -> torch.Tensor:
    """The K=24 keys (w0 << 32 | w1, sentinels for windows with an N) of a
    batch of random reads with 0.2 % N bases, on the card."""
    from allpathslg_tpu_torch.kmer import kmerize

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_reads, read_len)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 4
    canon, valid = kmerize.kmer_windows(torch.from_numpy(codes).cuda(),
                                        FLAGSHIP_K)
    flat, _ = kmerize.flatten_kmers(canon, valid, FLAGSHIP_K)
    return (flat[0] << 32) | flat[1]


def sort_lsd_bytes(n: int, passes: int) -> int:
    """Device-memory bytes of the kernel's design: one 8 B histogram read,
    20 B for the first pass (key in; key and index out), 24 B for each
    later one (the index is read too)."""
    return n * (8 + 20 + 24 * (passes - 1)) if passes else 8 * n


def sort_err(got, want) -> int:
    """Largest absolute difference of keys and permutation (0: equal)."""
    if got[0].numel() != want[0].numel():
        return 1 << 62
    if got[0].numel() == 0:
        return 0
    return max(int((got[0] - want[0]).abs().max()),
               int((got[1].long() - want[1].long()).abs().max()))


def phase_sort(codes: np.ndarray, seed: int):
    """Kernel vs plain version at the flagship shape, on adversarial keys
    and at three sizes in turns with torch.sort; returns the record."""
    from allpathslg_tpu_torch.kmer import kmerize
    from allpathslg_tpu_torch.ops import sort as ops_sort
    from allpathslg_tpu_torch.ops.cuda import sort_cuda

    dev = torch.device("cuda")
    canon, valid = kmerize.kmer_windows(torch.from_numpy(codes).to(dev),
                                        FLAGSHIP_K)
    flat, vmask = kmerize.flatten_kmers(canon, valid, FLAGSHIP_K)
    n = flat[0].numel()
    check(n == 16_646_144, f"flagship key count {n}")
    n_sent = int((~vmask).sum())
    check(n_sent > 0, "flagship keys hold no sentinel")
    rng = np.random.default_rng(seed + 1)
    dup = [torch.from_numpy(rng.integers(0, 4096, n).astype(np.int64)).to(dev),
           torch.from_numpy(rng.integers(0, 16, n).astype(np.int64)
                            << 16).to(dev)]
    max_err = 0

    def held(keys, key_bits, what):
        nonlocal max_err
        err = sort_err(sort_cuda.radix_sort(keys, key_bits),
                       sort_cuda.radix_sort_plain(keys, key_bits))
        check(err == 0, f"kernel != plain sort on {what}")
        max_err = max(max_err, err)

    for label, words in (("flagship K=24 keys with sentinels", flat),
                         ("duplicate-heavy keys", dup)):
        held((words[0] << 32) | words[1], 64, label)
        say(f"[sort] {label}: {n} keys, kernel == plain (keys and "
            f"stable permutation)")

    # one and three words with an int32 payload, through sort_by_words:
    # CUDA tensors take the kernel, CPU tensors the plain version
    payload = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n)
                               .astype(np.int32)).to(dev)
    w2 = torch.from_numpy(rng.integers(0, 5, n).astype(np.int64)).to(dev)
    for label, words in (("W=1", [dup[0]]), ("W=3", dup + [w2])):
        gw, (gp,) = ops_sort.sort_by_words(words, [payload])
        cw, (cp,) = ops_sort.sort_by_words([w.cpu() for w in words],
                                           [payload.cpu()])
        same = all(torch.equal(a.cpu(), b) for a, b in zip(gw, cw))
        check(same and torch.equal(gp.cpu(), cp),
              f"sort_by_words {label} differs from the plain version")
        say(f"[sort] {label} keys + int32 payload: {n} keys, "
            f"kernel == plain version")

    # adversarial keys: the histogram kernel against its plain version,
    # the planned passes, and the sort, exactly
    for case in SORT_CASES:
        for m in (1 << 20, 1):
            u, key_bits, want = adversarial_sort_keys(case, m,
                                                      seed + len(case))
            keys = torch.from_numpy(u.view(np.int64)).to(dev)
            hist, n_ones = sort_cuda.digit_histogram(keys, key_bits)
            p_hist, p_ones = sort_cuda.digit_histogram_plain(keys, key_bits)
            check(np.array_equal(hist, p_hist) and n_ones == p_ones,
                  f"histogram kernel != plain on {case}, n={m}")
            shifts = sort_cuda.plan_passes(hist, n_ones, m, key_bits)
            check(len(shifts) == (want if m > 1 else 0),
                  f"{case}: planned {shifts}, want {want} passes")
            held(keys, key_bits, f"{case}, n={m}")
        say(f"[sort] adversarial {case}: {1 << 20} and 1 keys of {key_bits} "
            f"bits, {want} passes planned; histogram and sort == plain")
    held(torch.empty(0, dtype=torch.int64, device=dev), 64, "0 keys")
    say("[sort] 0 keys: empty result, as the plain version's")

    # in turns: plain, kernel, torch.sort, torch.sort, kernel, plain
    key = (flat[0] << 32) | flat[1]
    sizes = (("flagship 131,072 x 150 bp", key),
             ("one count_reads batch, 65,536 x 100 bp",
              batch_keys(65_536, 100, seed + 4)),
             ("small", key[:65_536].clone()))
    check(sizes[1][1].numel() == 5_046_272,
          f"batch key count {sizes[1][1].numel()}")
    record = {}
    for label, k in sizes:
        m = k.numel()
        hist, n_ones = sort_cuda.digit_histogram(k, 64)
        check(np.array_equal(hist, sort_cuda.digit_histogram_plain(k, 64)[0]),
              f"histogram kernel != plain at {label}")
        passes = len(sort_cuda.plan_passes(hist, n_ones, m, 64))
        held(k, 64, label)
        flipped = k ^ (-(1 << 63))

        def plain():
            return sort_cuda.radix_sort_plain(k, 64)

        def kernel():
            return sort_cuda.radix_sort(k, 64)

        def library():
            return torch.sort(flipped, stable=True)

        t = [median_ms(f) for f in (plain, kernel, library, library, kernel,
                                    plain)]
        kern, lib, pl = min(t[1], t[4]), min(t[2], t[3]), min(t[0], t[5])
        floor_ms = sort_lsd_bytes(m, passes) / HBM_BYTES_PER_S * 1e3
        bound_ms = 20 * m / HBM_BYTES_PER_S * 1e3
        say(f"[sort] {label}: {m} keys, {n_ones} all-ones; median of "
            f"{TIMING_REPS} in turns: plain {t[0]:.3f} / {t[5]:.3f} ms, "
            f"kernel {t[1]:.3f} / {t[4]:.3f} ms, torch.sort {t[2]:.3f} / "
            f"{t[3]:.3f} ms; kernel {'beats' if kern < lib else 'LOSES TO'} "
            f"torch.sort")
        say(f"[sort] {label}: {passes} passes planned, "
            f"{sort_lsd_bytes(m, passes) / m:.0f} B/key, LSD floor "
            f"{floor_ms:.4f} ms = {100 * floor_ms / kern:.1f} % of the "
            f"kernel's time; bound (20 B/key) {bound_ms:.4f} ms")
        if not record:
            record = {"ms": kern, "plain_ms": pl, "library_ms": lib,
                      "bound_ms": bound_ms, "bound_by": "bytes"}
    return {"max_abs_err": max_err, **record}


def phase_spectrum(codes: np.ndarray):
    from allpathslg_tpu_torch.models.flagship import spectrum_step

    spec, nu = spectrum_step(torch.from_numpy(codes).cuda(), K=FLAGSHIP_K)
    torch.cuda.synchronize()
    cspec, cnu = spectrum_step(torch.from_numpy(codes), K=FLAGSHIP_K)
    check(torch.equal(spec.cpu(), cspec) and int(nu) == int(cnu),
          "spectrum_step on the card differs from the CPU plain version")
    check(int(spec.sum()) == int(nu), "spectrum mass != distinct kmers")
    say(f"[spectrum] spectrum_step(K=24): {int(nu)} distinct kmers, "
        f"equal to the plain version")


def dp_problems(rng, B: int, Lq: int, Lt: int, band: int,
                with_n: bool = False):
    """Banded-DP inputs like the align_frags rescue builds them: the
    target is a contig window, the query a copy of the window at the
    expected diagonal (offset = band) carrying substitutions and, for
    three reads in four, 1-2 indels (tests/test_align.py); ragged q_len
    and t_len, and some offsets out of range or off the diagonal. With
    `with_n`, 1 % of query bases and the last few target columns of some
    problems are code 4 (an N read against a window past a contig end)."""
    src = rng.integers(0, 4, (B, Lt + 2)).astype(np.uint8)
    j = np.arange(Lq)[None, :]
    kind = np.arange(B) % 4
    p1 = rng.integers(Lq // 5, Lq // 2, B)[:, None]
    p2 = rng.integers(Lq // 2, 4 * Lq // 5, B)[:, None]
    idx = np.broadcast_to(j + band, (B, Lq)).copy()
    idx += ((kind[:, None] == 1) | (kind[:, None] == 3)) & (j >= p1)  # del
    ins = ((kind[:, None] == 2) & (j >= p1)) | ((kind[:, None] == 3)
                                                 & (j >= p2))
    idx -= ins                                                       # ins
    q = np.take_along_axis(src, np.clip(idx, 0, Lt + 1), axis=1)
    ins_at = ((kind[:, None] == 2) & (j == p1)) | ((kind[:, None] == 3)
                                                    & (j == p2))
    q = np.where(ins_at, rng.integers(0, 4, (B, Lq)), q)
    sub = rng.random((B, Lq)) < 0.01
    q = np.where(sub, (q + rng.integers(1, 4, (B, Lq))) % 4, q)
    q_len = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    q_len[: B // 8] = Lq
    t_len = np.where(rng.random(B) < 0.2,
                     rng.integers(Lq // 2, Lt + 1, B), Lt).astype(np.int32)
    offset = np.full(B, band, np.int32)
    off_diag = rng.random(B) < 0.05
    offset[off_diag] = rng.integers(-band, band + 1, int(off_diag.sum()))
    bad = rng.random(B) < 0.03
    offset[bad] = np.where(rng.random(int(bad.sum())) < 0.5,
                           -(Lq + band) - rng.integers(1, 50, int(bad.sum())),
                           Lt + band + rng.integers(1, 50, int(bad.sum())))
    t = src[:, :Lt].copy()
    if with_n:
        q = np.where(rng.random((B, Lq)) < 0.01, 4, q)
        past_end = rng.random(B) < 0.3
        t[past_end, Lt - 6:] = 4
    q = np.where(j < q_len[:, None], q, 4).astype(np.uint8)
    return q, q_len, t, t_len, offset


def consensus_problems(rng, B: int = 256, n_real: int = 37, L: int = 32):
    """Bit-parallel DP inputs shaped like long/consensus.refine_consensus's
    batches: n_real problems of a read's window of the consensus (q_len
    20-30, 4 % substitutions) against a candidate variant of that window
    (the window itself, a 1-2 base deletion or a 1 base insertion), offset
    0, in a batch padded to B rows of q_len = t_len = 0 and code 4, as
    refine_consensus pads it."""
    q = np.full((B, L), 4, np.uint8)
    t = np.full((B, L), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i in range(n_real):
        a = int(rng.integers(20, 31))
        win = rng.integers(0, 4, a).astype(np.uint8)
        read = win.copy()
        sub = rng.random(a) < 0.04
        read[sub] = (read[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        x = int(rng.integers(1, a - 3))
        var = [win, np.delete(win, x), np.delete(win, [x, x + 1]),
               np.insert(win, x, np.uint8(rng.integers(0, 4)))][i % 4]
        q[i, :a], t[i, :len(var)] = read, var
        ql[i], tl[i] = a, len(var)
    return q, ql, t, tl, np.zeros(B, np.int32)


def medoid_problems(rng, B: int, L: int, n_real: int):
    """General-DP inputs shaped like asm/longread.consensus_patch's medoid
    batch: n = sqrt(n_real) noisy copies of one gap sequence (12 % error,
    half insertions, 30 % deletions, 20 % substitutions, as
    eval/sim.simulate_long_reads makes them) cut to lengths ragged within
    +- 12 % of L / 1.12, all n x n pairs (q = copy i, t = copy j, offset
    0), then rows of q_len = t_len = 0 and code 4 up to B. Pairs whose
    lengths differ by more than the band have no in-band path."""
    n = int(round(np.sqrt(n_real)))
    m = int(L / 1.12)
    truth = rng.integers(0, 4, m).astype(np.uint8)
    segs = []
    for _ in range(n):
        r = rng.random(m)
        keep = r >= 0.036                              # deletions
        s = truth[keep].copy()
        sub = rng.random(len(s)) < 0.024
        s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        ins = np.flatnonzero(rng.random(len(s)) < 0.06)
        s = np.insert(s, ins, rng.integers(0, 4, len(ins)).astype(np.uint8))
        want = int(rng.integers(int(0.88 * m), min(int(1.12 * m), L) + 1))
        if len(s) < want:
            s = np.concatenate([s, rng.integers(0, 4, want - len(s))])
        segs.append(s[:want].astype(np.uint8))
    q = np.full((B, L), 4, np.uint8)
    t = np.full((B, L), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for k in range(n * n):
        a, b = segs[k // n], segs[k % n]
        q[k, :len(a)], t[k, :len(b)] = a, b
        ql[k], tl[k] = len(a), len(b)
    return q, ql, t, tl, np.zeros(B, np.int32)


# Integer operations a DP row needs, counted as Hopper instructions (the
# int32 rate is one of instructions; LOP3 takes any logic function of
# three words). The bit-parallel row: the Myers/Hyyro recurrence of
# csrc/banded_bp.cu's header in the shortest form found, 12: SHF for
# M >> 1; X = Eq | (M >> 1) and V = Eq | (M >> 1) | P (2 LOP3); the sum
# X + V (IADD3); the carries c = sum ^ X ^ V (LOP3); Z = X | (P & c)
# (LOP3); d = c ^ Z (LOP3); P' = P ? ~d : d & Q with Q = c & ~M &
# bandmask, and M' = M ? ~d : d & R with R = ~c & ~P & bandmask (4 LOP3);
# bit 0 of Z into a word for s0 (SHF; its popcount once per 32 rows is
# left out). How a design forms each row's Eq word (a slid window, a
# funnel shift of prebuilt planes) is the design's own cost and not the
# work's, so it is left out: a bound that counted one design's Eq would
# let another design beat it. The general DP, per band slot of a row, as
# csrc/banded_general.cu issues it: the substitution cost (ISETP, SEL), the
# diagonal (IADD), min(up + gap, diagonal) and min(left + gap, that) (two
# DPX VIADDMNMX): 5. As for Eq above, how a design brings each slot its
# target code (there: a register shift and a shuffle a step) and its
# shuffles between lanes are the design's own cost, not counted (the
# earlier one-warp design's count was 9, with a prefix-min closure of 4).
BP_OPS_PER_ROW = 12
GENERAL_OPS_PER_SLOT = 5


def phase_banded(seed: int, int_rate: float):
    """The bit-parallel banded-DP kernel against its plain version,
    exactly (cost and t_end), at the align_frags rescue shape, at bands 1
    and 15, at bench.py's DP shape, and on an N-bearing batch (compared
    with the plain version on a query whose code 4 became 6, which matches
    nothing, as the kernel's query code 4 does). Returns the record."""
    from allpathslg_tpu_torch.ops import banded
    from allpathslg_tpu_torch.ops.cuda import banded_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 2)
    sets = [("a: align_frags rescue", 65_536, 260, 276, 8, False),
            ("b: band 1", 16_384, 150, 160, 1, False),
            ("b: band 15", 16_384, 260, 290, 15, False),
            ("c: bench.py DP shape", 16_384, 100, 140, 15, False),
            ("d: N-bearing, rescue shape", 65_536, 260, 276, 8, True),
            ("e: consensus-shaped, 37 real rows", 256, 32, 32, 6, False)]
    max_err = 0
    times = {}
    for label, B, Lq, Lt, band, with_n in sets:
        arrays = (consensus_problems(rng, B, 37, Lq) if label[0] == "e"
                  else dp_problems(rng, B, Lq, Lt, band, with_n))
        q, ql, t, tl, off = (torch.from_numpy(x).to(dev) for x in arrays)
        q_plain = torch.where(q == 4, 6, q) if with_n else q
        cost, t_end = banded_cuda.banded_align_bp(q, ql, t, tl, off, band)
        torch.cuda.synchronize()
        want_c, want_e = banded.banded_align(q_plain, ql, t, tl, off,
                                             band=band)
        err = max(int((cost - want_c).abs().max()),
                  int((t_end - want_e).abs().max()))
        check(err == 0, f"banded kernel != plain version on {label}")
        max_err = max(max_err, err)
        found = want_c < banded.BIG
        say(f"[banded] {label}: B={B}, Lq={Lq}, Lt={Lt}, band={band}: "
            f"kernel == plain (cost and t_end); {int(found.sum())} with an "
            f"in-band path, median cost "
            f"{float(want_c[found].float().median()):.0f}")
        if label[0] in "ace":
            def plain():
                return banded.banded_align(q, ql, t, tl, off, band=band)

            def kernel():
                return banded_cuda.banded_align_bp(q, ql, t, tl, off, band)

            turns = [median_ms(plain), device_ms(kernel), median_ms(plain),
                     device_ms(kernel)]
            bound = dp_bound(q, ql, t, off, band, BP_OPS_PER_ROW, int_rate)
            times[label[0]] = turns, bound
            say(f"[banded] {label}: in turns plain/kernel/plain/kernel: "
                f"plain {turns[0]:.3f} / {turns[2]:.3f} ms (median of "
                f"{TIMING_REPS}), kernel {turns[1]:.4f} / {turns[3]:.4f} ms "
                f"(device_ms); bound {bound[0]:.4f} ms by {bound[1]}")
    a, bound = times["a"]
    e, e_bound = times["e"]
    return {"max_abs_err": max_err, "set_a_ms": min(a[1], a[3]),
            "set_a_plain_ms": min(a[0], a[2]), "set_a_bound_ms": bound[0],
            "consensus_ms": min(e[1], e[3]),
            "consensus_plain_ms": min(e[0], e[2]),
            "consensus_bound_ms": e_bound[0],
            "consensus_bound_by": e_bound[1]}


def patch_problems(rng, B: int, Lq: int, Lt: int, band: int):
    """General-DP inputs shaped like patch_gaps' negative junctions
    (asm/patch.py): contig c2's first A bases (the query, A = q_len,
    ragged in (Lq / 2, Lq]) against the last T bases of contig c1, with
    slack = 3 * max(gap_dev, 4) in the band's bucket (band = _round_band(
    slack + 4)), gap g = -(A + slack), T = min(len(c1), -g + slack + A +
    12) within Lt and offset T + g; the query is the target's window at
    the offset with 1 % substitutions. The last problem is the batch's
    padding (q_len = t_len = offset = 0, codes 4), as _DPBatch pads B."""
    lower = {12: 0, 24: 12, 48: 24, 96: 48, 192: 96}[band]
    q = np.full((B, Lq), 4, np.uint8)
    t = np.full((B, Lt), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    off = np.zeros(B, np.int32)
    for i in range(B - 1):
        slack = int(rng.integers(max(lower - 3, 9), band - 3))
        A = int(rng.integers(Lq // 2 + 1, Lq + 1))
        T = min(Lt, 2 * A + 2 * slack + 12, int(rng.integers(Lt // 2, 4 * Lt)))
        o = T - A - slack
        tt = rng.integers(0, 4, T).astype(np.uint8)
        qq = tt[max(o, 0):max(o, 0) + A].copy()
        qq = np.concatenate([qq, rng.integers(0, 4, A - len(qq))]).astype(
            np.uint8)
        sub = rng.random(A) < 0.01
        qq[sub] = (qq[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        q[i, :A], t[i, :T] = qq, tt
        ql[i], tl[i], off[i] = A, T, o
    return q, ql, t, tl, off


def edge_problems(rng, B: int, Lq: int, Lt: int, band: int):
    """Every q_len = Lq; targets shorter than the band's K = 2 * band + 1
    for half the problems; offsets cycling over both edges of the feasible
    window [-(Lq + band), Lt + band], one past each, the edges of column 0
    entering and leaving the band, and a diagonal inside."""
    K = 2 * band + 1
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    ql = np.full(B, Lq, np.int32)
    tl = np.where(np.arange(B) % 2 == 0, rng.integers(1, min(K, Lt + 1), B),
                  Lt).astype(np.int32)
    edges = np.array([-(Lq + band), -(Lq + band) + 1, -(Lq + band) - 1,
                      -band - 1, -band, band, band + 1, Lt + band - 1,
                      Lt + band, Lt + band + 1, 0], np.int32)
    off = edges[np.arange(B) % len(edges)]
    inside = np.arange(B) % len(edges) == len(edges) - 1
    off[inside] = rng.integers(-band, band + 1, int(inside.sum()))
    for i in np.flatnonzero(inside):
        o = max(int(off[i]), 0)
        n = max(0, min(Lq, Lt - o))
        q[i, :n] = t[i, o:o + n]
    return q, ql, t, tl, off


# Phase 6's input sets: (label, inputs, B, Lq, Lt, band, sub_cost,
# gap_cost, timed); "dp" is dp_problems with 2 % of q_len set to 0, "n"
# the same with N codes
GENERAL_SETS = (
    [(f"1: patch-like, band {b}", "dp", 16_384, 256, 512, b, 1, 1, b == 96)
     for b in (16, 24, 48, 96, 192)]
    + [("2: sub_cost=2 gap_cost=3", "dp", 16_384, 256, 512, 24, 2, 3, False),
       ("3: bench.py shape", "dp", 16_384, 100, 140, 15, 1, 1, True),
       ("4: N-bearing, band 96", "n", 16_384, 256, 512, 96, 1, 1, False)]
    + [(f"5: run_full patch_gaps B = 8, band {b}", "patch", 8, lq, 512, b,
        1, 1, True) for b, lq in ((192, 64), (96, 128), (48, 128))]
    + [("6: assisted B = 1, band 16", "dp", 1, 128, 160, 16, 1, 1, True)]
    + [(f"7: band {b}", "dp", 4096, lq, lt, b, 1, 1, False)
       for b, lq, lt in ((0, 100, 140), (1, 100, 140), (2, 100, 140),
                         (15, 100, 140), (255, 64, 600))]
    + [("8: edges, band 96, t_len < K, q_len = Lq", "edge", 4096, 64, 160,
        96, 1, 1, False),
       ("8: edges, band 1, t_len < K, q_len = Lq", "edge", 4096, 64, 160,
        1, 2, 3, False)]
    + [(f"9: medoid, {n} real rows, band {b}", "medoid", 128, L, L, b, 1,
        1, True) for n, L, b in ((121, 3072, 192), (121, 3072, 96),
                                 (16, 12_000, 192))])


def phase_banded_general(seed: int, int_rate: float, chain: dict):
    """The general banded-DP kernel against its plain version, exactly
    (cost and t_end), on GENERAL_SETS; kernel (device_ms) and plain version
    (median_ms) timed in turns on the timed sets, each with its three bound
    terms. Returns the record: set 1 at band 96 as ms / plain_ms /
    bound_ms, the B = 8 sets, set 6 and set 3 under their own keys."""
    from allpathslg_tpu_torch.ops import banded
    from allpathslg_tpu_torch.ops.cuda import banded_general_cuda as bg

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 3)
    max_err = 0
    times = {}
    for label, kind, B, Lq, Lt, band, sc, gc, timed in GENERAL_SETS:
        if kind == "patch":
            arrays = patch_problems(rng, B, Lq, Lt, band)
        elif kind == "edge":
            arrays = edge_problems(rng, B, Lq, Lt, band)
        elif kind == "medoid":
            arrays = medoid_problems(rng, B, Lq, int(label.split()[2]))
        else:
            q, ql, t, tl, off = dp_problems(rng, B, Lq, Lt, band, kind == "n")
            if B > 1:
                ql[rng.random(B) < 0.02] = 0
            q = np.where(np.arange(Lq)[None, :] < ql[:, None], q, 4).astype(
                np.uint8)
            arrays = q, ql, t, tl, off
        q, ql, t, tl, off = (torch.from_numpy(x).to(dev) for x in arrays)

        def kernel():
            return bg.banded_align_general(q, ql, t, tl, off, band=band,
                                           sub_cost=sc, gap_cost=gc)

        def plain():
            return bg.banded_general_plain(q, ql, t, tl, off, band=band,
                                           sub_cost=sc, gap_cost=gc)

        cost, t_end = kernel()
        torch.cuda.synchronize()
        want_c, want_e = plain()
        err = max(int((cost - want_c).abs().max()),
                  int((t_end - want_e).abs().max()))
        check(err == 0, f"general banded kernel != plain version on {label}")
        max_err = max(max_err, err)
        found = want_c < banded.BIG
        say(f"[general] {label}: B={B}, Lq={Lq}, Lt={Lt}, band={band}, "
            f"costs ({sc},{gc}): kernel == plain (cost and t_end); "
            f"{int(found.sum())} with an in-band path, "
            f"{int((ql == 0).sum())} with q_len 0")
        if kind == "medoid":
            real = ql > 0
            check(bool((~found & real).any()) and bool((found & real).any()),
                  f"{label}: want both feasible and infeasible pairs")
            check(bool((want_e[~found] == -1).all()),
                  f"{label}: an infeasible pair's t_end is not -1")
        if timed:
            # the plain version loops over Lq rows in Python: few reps at
            # the medoid's thousands of rows
            reps = 2 if kind == "medoid" else TIMING_REPS
            turns = [median_ms(plain, reps), device_ms(kernel),
                     median_ms(plain, reps), device_ms(kernel)]
            bound, by, terms = general_bound(q, ql, t, off, band, int_rate,
                                             chain)
            kern = min(turns[1], turns[3])
            times[label] = {"ms": kern, "plain_ms": min(turns[0], turns[2]),
                            "bound_ms": bound, "bound_by": by}
            say(f"[general] {label}: in turns plain/kernel/plain/kernel: "
                f"plain {turns[0]:.3f} / {turns[2]:.3f} ms (median of "
                f"{reps}), kernel {turns[1]:.5f} / {turns[3]:.5f} ms "
                f"(device_ms); bound {bound:.5f} ms by {by} "
                f"({100 * bound / kern:.1f} % of it; terms ms: "
                f"{show_terms(terms)})")
    big = times["1: patch-like, band 96"]
    b8 = [times[f"5: run_full patch_gaps B = 8, band {b}"]
          for b in (192, 96, 48)]
    b1 = times["6: assisted B = 1, band 16"]
    bench = times["3: bench.py shape"]
    medoid = [v for k, v in times.items() if k.startswith("9:")]
    return {"max_abs_err": max_err, **big, "library_ms": None,
            "medoid_shapes": ["128 x 3072 x 3072 band 192",
                              "128 x 3072 x 3072 band 96",
                              "128 x 12000 x 12000 band 192"],
            "medoid_ms": [x["ms"] for x in medoid],
            "medoid_plain_ms": [x["plain_ms"] for x in medoid],
            "medoid_bound_ms": [x["bound_ms"] for x in medoid],
            "medoid_bound_by": [x["bound_by"] for x in medoid],
            "b8_ms": [x["ms"] for x in b8],
            "b8_bound_ms": [x["bound_ms"] for x in b8],
            "b8_bound_by": [x["bound_by"] for x in b8],
            "b1_band16_ms": b1["ms"], "b1_band16_bound_ms": b1["bound_ms"],
            "bench_shape_ms": bench["ms"],
            "bench_shape_bound_ms": bench["bound_ms"]}


def _canonical_kmers(codes: np.ndarray, K: int):
    """(canonical 2-bit packed K-mers uint64 [R, P], valid [R, P])."""
    R, L = codes.shape
    P = L - K + 1
    win = np.lib.stride_tricks.sliding_window_view(codes, K, axis=1)
    valid = (win < 4).all(axis=2)
    c = np.where(win < 4, win, 0).astype(np.uint64)
    shifts = (2 * np.arange(K - 1, -1, -1)).astype(np.uint64)
    fwd = (c << shifts).sum(axis=2, dtype=np.uint64)
    rev = ((3 - c)[:, :, ::-1] << shifts).sum(axis=2, dtype=np.uint64)
    assert fwd.shape == (R, P)
    return np.minimum(fwd, rev), valid


def true_kmer_frac(codes: np.ndarray, genome_kmers: np.ndarray, K: int,
                   n_sample: int = 512) -> float:
    """Fraction of a read sample's K-mers present in the genome (the
    reference's _cheat_true_kmer_frac: evenly spaced rows, N windows
    skipped)."""
    idx = np.linspace(0, len(codes) - 1, min(n_sample, len(codes)),
                      dtype=np.int64)
    kmers, valid = _canonical_kmers(np.asarray(codes[idx]), K)
    hit = np.isin(kmers[valid], genome_kmers)
    return round(float(hit.sum()) / max(int(valid.sum()), 1), 5)


SLICE_STAGES = ("validate_inputs", "remove_dodgy", "precorrect",
                "find_errors", "clean_reads", "fill_fragments", "unipaths",
                "report", "align_frags")


def phase_slice(genome_size: int, seed: int):
    """The contig slice and align_frags through Pipeline(device="cuda");
    returns each kernel's launches in the run."""
    from allpathslg_tpu_torch.ops.cuda import banded_cuda, sort_cuda
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.run import prepare_sim_inputs
    from allpathslg_tpu_torch.pipeline.stages import Pipeline

    run_dir = ROOT / "build" / "chip_smoke_run"
    shutil.rmtree(run_dir, ignore_errors=True)
    rd = RunDir(str(run_dir))
    quiet = lambda *a: None  # noqa: E731
    coverage, read_len, err = 100.0, 100, 0.005
    t0 = time.perf_counter()
    prepare_sim_inputs(rd, genome_size, coverage, err, read_len, seed, quiet)
    say(f"[slice] prepare_sim_inputs: genome {genome_size} bp, "
        f"{coverage:g}x, {read_len} bp reads, error {err}: "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = AssemblyConfig.from_overrides()

    def log(msg: str):  # the unipaths stage's own step times
        if msg.startswith("  [unipaths]"):
            say(f"[slice] {msg.strip()}")

    pipe = Pipeline(rd, cfg, log, device="cuda")
    kernels = {"sort": sort_cuda, "banded": banded_cuda}
    for mod in kernels.values():
        mod.reset_launch_count()
    metrics, launches = {}, {}
    for stage in SLICE_STAGES:
        before = {k: m.launch_count() for k, m in kernels.items()}
        t = time.perf_counter()
        metrics[stage] = getattr(pipe, stage)()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[stage] = {k: m.launch_count() - before[k]
                           for k, m in kernels.items()}
        shown = {k: v for k, v in metrics[stage].items() if k != "libraries"}
        say(f"[slice] {stage}: {dt:.1f} s, kernel launches "
            f"sort {launches[stage]['sort']}, banded "
            f"{launches[stage]['banded']}; {shown}")
    total = {k: m.launch_count() for k, m in kernels.items()}
    for stage in ("validate_inputs", "precorrect", "find_errors",
                  "unipaths"):
        check(launches[stage]["sort"] > 0,
              f"{stage} never launched the sort kernel")
    check(launches["align_frags"]["banded"] > 0,
          "align_frags never launched the banded kernel")

    est = metrics["validate_inputs"]["genome_size_est"]
    check(abs(est - genome_size) <= 0.2 * genome_size,
          f"genome_size_est {est} not within 20% of {genome_size}")
    n_fix = (metrics["precorrect"]["n_corrections"],
             metrics["find_errors"]["n_corrections"])
    check(n_fix[1] > 0, "find_errors made no corrections")

    genome = rd.load_arrays("genome_truth")["genome"]
    gk, gv = _canonical_kmers(genome[None, :], cfg.K_ec)
    genome_kmers = np.unique(gk[gv])
    before = true_kmer_frac(rd.load_arrays("frag_reads_orig", mmap=True)
                            ["codes"], genome_kmers, cfg.K_ec)
    after = true_kmer_frac(rd.load_arrays("frag_reads_corr", mmap=True)
                           ["codes"], genome_kmers, cfg.K_ec)
    check(after > before, f"true 24-mer fraction fell: {before} -> {after}")
    say(f"[slice] genome_size_est {est} (truth {genome_size}); corrections "
        f"precorrect {n_fix[0]}, find_errors {n_fix[1]}; true 24-mer "
        f"fraction {before} -> {after}")

    rep = metrics["report"]
    check(abs(rep["total_bases"] - genome_size) <= 0.05 * genome_size,
          f"contig total {rep['total_bases']} not within 5% of "
          f"{genome_size}")
    check(rep["n50"] >= min(100_000, genome_size // 2),
          f"contig N50 {rep['n50']} < 100 kb")
    rate = metrics["align_frags"]["align_rate"]
    check(rate >= 0.90, f"align_frags align_rate {rate} < 0.90")
    report = Path(rd.file_path("assembly.report"))
    check(report.exists() and f"contig N50: {rep['n50']}" in
          report.read_text(), "assembly.report missing or without the N50")
    say(f"[slice] contigs {rep['n_contigs']}, total {rep['total_bases']} bp "
        f"(genome {genome_size}), N50 {rep['n50']}, max {rep['max_len']}; "
        f"align_frags align_rate {rate}; assembly.report names the N50")
    shutil.rmtree(run_dir, ignore_errors=True)
    return total


# (segment length, copies): an E. coli-like chromosome's repeat families,
# seven rRNA-operon-like 5 kb copies, ten IS-like 1.3 kb copies and three
# two-copy 2.5 kb repeats; half the copies lie reverse-complemented
REPEAT_FAMILIES = ((5000, 7), (1300, 10), (2500, 2), (2500, 2), (2500, 2))
FULL_STAGES = ("validate_inputs", "remove_dodgy", "precorrect",
               "find_errors", "clean_reads", "fill_fragments", "unipaths",
               "jump_ec", "align_jumps", "make_scaffolds", "align_frags",
               "patch_gaps", "polish", "clean_final", "finalize",
               "submission_prep", "evaluate", "report")


def repeat_genome(size: int, seed: int) -> np.ndarray:
    """A random genome with REPEAT_FAMILIES: the copies are spread one per
    slot of size / n_copies, each at a random place in its slot; a family's
    later copies repeat its first, forward or reverse-complemented."""
    from allpathslg_tpu_torch.eval import sim

    g = sim.random_genome(size, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    copies = [(fi, n) for fi, (n, c) in enumerate(REPEAT_FAMILIES)
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
            seg = (3 - seg[::-1]) % 4
        g[at:at + n] = seg
    return g


INSERT, INSERT_SD = 3000, 300


def full_inputs(rd, genome_size: int, seed: int):
    """Save run_full's inputs in run dir `rd`: the repeat genome, 100x
    fragment reads and 50x jump reads of INSERT +- INSERT_SD (100 bp, 0.5 %
    error), from `seed`."""
    from allpathslg_tpu_torch.eval import sim

    t0 = time.perf_counter()
    g = repeat_genome(genome_size, seed)
    fb, fp, _ = sim.simulate_paired_reads(g, coverage=100.0, read_len=100,
                                          error_rate=0.005, seed=seed + 1)
    rd.save_arrays("frag_reads_orig", codes=np.asarray(fb.codes),
                   lengths=np.asarray(fb.lengths), quals=np.asarray(fb.quals),
                   pairs=np.asarray(fp.pairs))
    jb, jp, _ = sim.simulate_paired_reads(
        g, coverage=50.0, read_len=100, error_rate=0.005, insert_mean=INSERT,
        insert_sd=INSERT_SD, outward=True, seed=seed + 2)
    rd.save_arrays("jump_reads_orig", codes=np.asarray(jb.codes),
                   lengths=np.asarray(jb.lengths), quals=np.asarray(jb.quals),
                   pairs=np.asarray(jp.pairs),
                   lib_id=np.zeros(len(jp.pairs), np.int32),
                   lib_sep=np.array([INSERT], np.int32),
                   lib_sd=np.array([INSERT_SD], np.int32))
    rd.save_arrays("genome_truth", genome=g)
    say(f"[full] inputs: genome {genome_size} bp with repeat families "
        f"{REPEAT_FAMILIES}; {fb.n_reads} fragment reads (100x), "
        f"{jb.n_reads} jump reads (50x, {INSERT} +- {INSERT_SD}): "
        f"{time.perf_counter() - t0:.1f} s")


def lane_idle_share(q_len: np.ndarray, Lq: int, warp: int = 32) -> float:
    """1 - (rows the queries ask for) / (rows the warps run), a warp of 32
    consecutive problems running as long as its longest query (the
    bit-parallel kernel's rows: q_len when 1 <= q_len <= Lq rounded up to
    32, else 0)."""
    lq_pad = (Lq + 31) // 32 * 32
    rows = np.where((q_len >= 1) & (q_len <= lq_pad), q_len, 0).astype(
        np.int64)
    rows = np.pad(rows, (0, -len(rows) % warp)).reshape(-1, warp)
    ran = int(rows.max(axis=1).sum()) * warp
    return 1.0 - int(rows.sum()) / ran if ran else 0.0


class DPCapture:
    """Wraps the two DP kernels' wrappers while run_full runs (the module
    attributes that ops/banded.banded_align_auto calls): counts each
    kernel's calls by (stage, B x Lq x Lt, band), with q_len min / mean /
    max, and keeps a device copy of the inputs and outputs of the first
    KEEP calls of each (under a cap a stage, the largest by B x Lq x Lt).
    Stats and copies are taken on the stream, so the run never waits for
    them."""

    KEEP = 2
    KERNELS = (("banded_cuda", "banded_align_bp", "banded_bp"),
               ("banded_general_cuda", "banded_align_general",
                "banded_general"))

    def __init__(self, keep_per_stage: int = None):
        """keep_per_stage: at most this many kept calls of one kernel in
        one stage (None: no cap), for stages whose every call has its own
        shape; past the cap a larger call takes the place of the
        smallest kept one."""
        import threading

        self._lock = threading.Lock()
        self.keep_per_stage = keep_per_stage
        self.calls = {}   # (kernel, stage, B, Lq, Lt, band) -> [stats]
        self.kept = {}    # the same key -> [(inputs, kwargs, outputs)]
        self._saved = []

    def install(self):
        import importlib

        for module, attr, kernel in self.KERNELS:
            mod = importlib.import_module(
                f"allpathslg_tpu_torch.ops.cuda.{module}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(kernel, fn))

    def remove(self):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []

    def _wrap(self, kernel, fn):
        import inspect

        from allpathslg_tpu_torch.ops.cuda import launches

        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            q, t = a["q"], a["t"]
            kw = {k: a[k] for k in ("band", "sub_cost", "gap_cost") if k in a}
            key = (kernel, launches.current_stage(), q.shape[0], q.shape[1],
                   t.shape[1], kw["band"])
            ql = a["q_len"].to(torch.int64)
            stats = (torch.stack([ql.min(), ql.sum(), ql.max()])
                     if ql.numel() else torch.zeros(3, dtype=torch.int64))
            out = fn(*args, **kwargs)
            with self._lock:
                self.calls.setdefault(key, []).append(stats)
                if len(self.kept.get(key, [])) >= self.KEEP:
                    return out
                in_stage = [k for k in self.kept if k[:2] == key[:2]
                            for _ in self.kept[k]]
                if (self.keep_per_stage is not None
                        and len(in_stage) >= self.keep_per_stage):
                    smallest = min(in_stage, key=_size)
                    if _size(smallest) >= _size(key):
                        return out
                    self.kept[smallest].pop()
                    if not self.kept[smallest]:
                        del self.kept[smallest]
                self.kept.setdefault(key, []).append((tuple(
                    a[k].clone() for k in (
                        "q", "q_len", "t", "t_len", "offset")), kw,
                    tuple(x.clone() for x in out)))
            return out

        return wrapped


def _size(key) -> int:
    """B x Lq x Lt of a DPCapture key."""
    return key[2] * key[3] * key[4]


def _dp_fns():
    from allpathslg_tpu_torch.ops.cuda import banded_cuda
    from allpathslg_tpu_torch.ops.cuda import banded_general_cuda as bg

    return {"banded_bp": (banded_cuda.banded_align_bp,
                          banded_cuda.banded_align_bp_plain),
            "banded_general": (bg.banded_align_general,
                               bg.banded_general_plain)}


def dp_calls_held(capture: DPCapture, tag: str, stages=None) -> dict:
    """Prints the count and q_len of each captured (kernel, stage, shape,
    band) and holds every kept call of `stages` (all when None) against
    the plain version, exactly. Returns the largest error by kernel."""
    fns = _dp_fns()
    for key in sorted(capture.calls, key=str):
        kernel, stage, B, Lq, Lt, band = key
        st = torch.stack(capture.calls[key]).cpu()
        n = st.shape[0]
        say(f"[{tag}] {kernel} in {stage}: {n} calls at {B} x {Lq} x {Lt}, "
            f"band {band}; q_len min {int(st[:, 0].min())} / mean "
            f"{float(st[:, 1].sum()) / (n * B):.1f} / max "
            f"{int(st[:, 2].max())}")
    max_err = {"banded_bp": 0, "banded_general": 0}
    for key, kept in sorted(capture.kept.items(), key=lambda kv: str(kv[0])):
        kernel = key[0]
        if stages is not None and key[1] not in stages:
            continue
        for arrays, kw, out in kept:
            want = fns[kernel][1](*arrays, **kw)
            err = max(int((out[0] - want[0]).abs().max()),
                      int((out[1] - want[1]).abs().max()))
            check(err == 0, f"{kernel} != plain version on a {key[1]} call "
                  f"of run_full ({key[2]} x {key[3]} x {key[4]}, band "
                  f"{key[5]})")
            max_err[kernel] = max(max_err[kernel], err)
        say(f"[{tag}] {kernel} in {key[1]}, {key[2]} x {key[3]} x {key[4]}, "
            f"band {key[5]}: {len(kept)} kept calls == plain (cost and "
            f"t_end)")
    return max_err


def dp_timed(capture: DPCapture, key, int_rate: float, chain: dict,
             tag: str, plain_reps: int = TIMING_REPS) -> dict:
    """Kernel (device_ms) and plain version (median_ms of plain_reps) in
    turns on the first kept call of `key`, with its bound (the general
    kernel's three terms, general_bound)."""
    kernel = key[0]
    arrays, kw, _ = capture.kept[key][0]
    kern, plain = _dp_fns()[kernel]
    turns = [median_ms(lambda: plain(*arrays, **kw), plain_reps),
             device_ms(lambda: kern(*arrays, **kw)),
             median_ms(lambda: plain(*arrays, **kw), plain_reps),
             device_ms(lambda: kern(*arrays, **kw))]
    q, ql, t = arrays[:3]
    if kernel == "banded_bp":
        bound = dp_bound(q, ql, t, arrays[4], key[5], BP_OPS_PER_ROW,
                         int_rate)
        terms = ""
    else:
        *bound, terms = general_bound(q, ql, t, arrays[4], key[5],
                                      int_rate, chain)
        terms = f"; terms ms: {show_terms(terms)}"
    idle = (f", idle lane-rows "
            f"{100 * lane_idle_share(ql.cpu().numpy(), q.shape[1]):.1f} %"
            if kernel == "banded_bp" else "")
    say(f"[{tag}] {kernel} on a batch of run_full's {key[1]}, {key[2]} x "
        f"{key[3]} x {key[4]}, band {key[5]} (q_len mean "
        f"{float(ql.float().mean()):.1f}{idle}): in turns "
        f"plain/kernel/plain/kernel: "
        f"plain {turns[0]:.3f} / {turns[2]:.3f} ms (median of "
        f"{plain_reps}), kernel {turns[1]:.5f} / {turns[3]:.5f} ms "
        f"(device_ms); "
        f"bound {bound[0]:.5f} ms by {bound[1]} "
        f"({100 * bound[0] / min(turns[1], turns[3]):.1f} % of it"
        f"{terms})")
    return {"shape": f"{key[2]} x {key[3]} x {key[4]} band {key[5]}",
            "ms": min(turns[1], turns[3]),
            "plain_ms": min(turns[0], turns[2]),
            "bound_ms": bound[0], "bound_by": bound[1]}


def phase_dp_batches(capture: DPCapture, int_rate: float,
                     chain: dict):
    """The DP calls run_full made: the count and q_len of each (kernel,
    stage, shape, band); every kept call's outputs against the plain
    version, exactly; kernel and plain version timed in turns on the
    first kept align_frags and align_jumps batch of the bit-parallel
    kernel and on every kept batch of the general one (with its three
    bound terms, general_bound). Returns (bit-parallel record, general
    record)."""
    max_err = dp_calls_held(capture, "dp")
    bp = {}
    for stage in ("align_frags", "align_jumps"):
        keys = [k for k in capture.kept if k[:2] == ("banded_bp", stage)]
        check(bool(keys), f"run_full made no bit-parallel call in {stage}")
        bp[stage] = dp_timed(capture, max(keys, key=lambda k: k[2] * k[3]),
                             int_rate, chain, "dp")
    general = [dp_timed(capture, k, int_rate, chain, "dp")
               for k in sorted(capture.kept, key=str)
               if k[0] == "banded_general"]
    bp_record = {"max_abs_err": max_err["banded_bp"], **bp["align_frags"],
                 "library_ms": None,
                 "align_jumps_ms": bp["align_jumps"]["ms"],
                 "align_jumps_plain_ms": bp["align_jumps"]["plain_ms"],
                 "align_jumps_bound_ms": bp["align_jumps"]["bound_ms"]}
    bp_record.pop("shape")
    general_record = {"max_abs_err": max_err["banded_general"],
                      "run_full_ms": [g["ms"] for g in general],
                      "run_full_plain_ms": [g["plain_ms"] for g in general],
                      "run_full_bound_ms": [g["bound_ms"] for g in general],
                      "run_full_bound_by": [g["bound_by"] for g in general]}
    return bp_record, general_record


def phase_full(genome_size: int, seed: int, capture: DPCapture):
    """run_full on the card at the binding libraries over a repeat-bearing
    genome, with `capture` installed around it; returns each kernel's
    launches in the run."""
    from allpathslg_tpu_torch.eval import stats
    from allpathslg_tpu_torch.ops.cuda import launches
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.stages import Pipeline
    from allpathslg_tpu_torch.scaffold import superb

    run_dir = ROOT / "build" / "chip_smoke_full"
    shutil.rmtree(run_dir, ignore_errors=True)
    rd = RunDir(str(run_dir))
    full_inputs(rd, genome_size, seed)

    cfg = AssemblyConfig.from_overrides()
    pipe = Pipeline(rd, cfg, lambda *a: None, device="cuda")
    launches.reset()
    capture.install()
    try:
        t0 = time.perf_counter()
        pipe.run_full()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        capture.remove()
    by_stage = launches.by_stage()
    total = {k: launches.count(k) for k in ("radix_sort", "banded_bp",
                                             "banded_general")}
    stages = rd.manifest["stages"]
    for stage in FULL_STAGES:
        rec = stages[stage]
        shown = {k: v for k, v in rec["metrics"].items() if k != "libraries"}
        say(f"[full] {stage}: {rec['elapsed_s']:.1f} s, launches "
            f"{by_stage.get(stage, {})}; {shown}")
    say(f"[full] run_full: {wall:.1f} s wall with stage_workers="
        f"{cfg.stage_workers}; launches {total}")

    check(total["banded_general"] > 0, "run_full never launched the "
          "general banded kernel")
    general_stages = {s for s, c in by_stage.items() if "banded_general" in c}
    check(general_stages == {"patch_gaps"}, f"general kernel launched in "
          f"{general_stages}, expected patch_gaps only")
    for stage in ("align_frags", "align_jumps"):
        check(by_stage.get(stage, {}).get("banded_bp", 0) > 0,
              f"{stage} never launched the bit-parallel kernel")
    m = {s: rd.metrics(s) for s in FULL_STAGES}
    aj = m["align_jumps"]
    check(abs(aj["insert_mean_est"] - INSERT) <= 0.1 * INSERT,
          f"jump insert estimate {aj['insert_mean_est']} not within 10% of "
          f"{INSERT}")
    sc, pg, ev = m["make_scaffolds"], m["patch_gaps"], m["evaluate"]
    check(pg["n_gaps_closed"] >= 1, "patch_gaps closed no gap")
    check(ev["genome_covered_frac"] >= 0.95,
          f"genome covered {ev['genome_covered_frac']} < 0.95")
    for name in ("final.assembly.fasta", "submission/contigs.fsa",
                 "submission/scaffolds.fsa"):
        path = Path(rd.file_path(name))
        check(path.exists() and path.stat().st_size > 0, f"{name} missing")
    rep = m["report"]
    final = stats.assembly_stats([
        sb.length(np.diff(rd.load_arrays("contigs_final")["offsets"]))
        for sb in superb.read_superb(rd.file_path("assembly.superb"))])
    say(f"[full] align_jumps: align_rate {aj['align_rate']}, insert "
        f"{aj['insert_mean_est']} +- {aj['insert_sd_est']} (simulated "
        f"{INSERT} +- {INSERT_SD}); make_scaffolds: {sc['n_scaffolds']} "
        f"scaffolds, N50 {sc['scaffold_n50']}; gaps closed "
        f"{pg['n_gaps_closed']}; final assembly: {final['n_contigs']} "
        f"scaffolds, N50 {final['n50']}, {final['total_bases']} bp; "
        f"{rep['n_contigs']} contigs, contig N50 {rep['n50']}; "
        f"evaluate: genome covered {ev['genome_covered_frac']}, misassembly "
        f"breaks {ev['misassembly_breaks']}, base error rate "
        f"{ev['base_error_rate']} (sub {ev['sub_rate']}, indel "
        f"{ev['indel_rate']}); final.assembly.fasta and submission/*.fsa "
        f"written")
    shutil.rmtree(run_dir, ignore_errors=True)
    return total


# Phase 9's inputs and files, as tests/test_torch_full.py makes and
# compares them: a 40 kb genome with a two-copy 2.5 kb exact repeat, 40x
# fragment reads and 15x jump reads of 4000 +- 350, batch_reads 4096
CMP_GENOME, CMP_REPEAT, CMP_LOCI = 40_000, 2_500, (10_000, 25_000)
CMP_ARTIFACTS = ("kspec_25mer", "jump_reads_ec", "jump_alignlets",
                 "jump_distribs", "frag_alignlets", "unibases",
                 "contigs_final")
CMP_TEXT_FILES = ("assembly.superb", "assembly.agp", "final.assembly.fasta",
                  "final.assembly.efasta", "submission/contigs.fsa",
                  "submission/assembly.agp", "submission/scaffolds.fsa",
                  "assembly.report")


def cmp_inputs() -> dict:
    """The 40 kb repeat genome's inputs for save_inputs (the port's
    eval/sim with tests/test_torch_full.py's seeds)."""
    from allpathslg_tpu_torch.eval import sim

    g = sim.random_genome(CMP_GENOME, seed=71)
    a, b = CMP_LOCI
    g[b:b + CMP_REPEAT] = g[a:a + CMP_REPEAT]
    fb, fp, _ = sim.simulate_paired_reads(g, coverage=40, error_rate=0.005,
                                          seed=1)
    jb, jp, _ = sim.simulate_paired_reads(
        g, coverage=15, error_rate=0.005, insert_mean=4000, insert_sd=350,
        outward=True, seed=2)
    return {
        "frag_reads_orig": dict(codes=fb.codes, lengths=fb.lengths,
                                quals=fb.quals, pairs=fp.pairs),
        "jump_reads_orig": dict(codes=jb.codes, lengths=jb.lengths,
                                quals=jb.quals, pairs=jp.pairs,
                                lib_sep=np.array([4000], np.int32),
                                lib_sd=np.array([350], np.int32)),
        "genome_truth": dict(genome=g),
    }


def save_inputs(rd, inputs: dict):
    """Save {artifact: {key: array}} in run dir `rd`."""
    for art, arrays in inputs.items():
        rd.save_arrays(art, **{k: np.asarray(v) for k, v in arrays.items()})


def jump_libs(specs) -> dict:
    """A jump artifact's arrays (tests/test_scale_diploid_multilib.py's
    _jump_libs): specs [(haplotype, insert, sd, coverage, seed)], outward
    pairs of 100 bp at 0.4 % error, one library each."""
    from allpathslg_tpu_torch.eval import sim
    from allpathslg_tpu_torch.pipeline.run import jump_lib_arrays

    parts = []
    for hp, ins, sd, cov, seed in specs:
        jb, jp, _ = sim.simulate_paired_reads(
            hp, coverage=cov, error_rate=0.004, insert_mean=ins,
            insert_sd=sd, outward=True, seed=seed)
        parts.append((ins, sd, jb, jp))
    return jump_lib_arrays(parts)


def mixed_frags(haps, coverage_each: float, seeds) -> dict:
    """Fragment reads from each haplotype at 0.4 % error, pooled
    (tests/test_scale_diploid_multilib.py's _mix_frag)."""
    from allpathslg_tpu_torch.eval import sim

    parts, pair_parts, at = [], [], 0
    for hp, sd in zip(haps, seeds):
        b, p, _ = sim.simulate_paired_reads(hp, coverage=coverage_each,
                                            error_rate=0.004, seed=sd)
        parts.append((np.asarray(b.codes), np.asarray(b.lengths),
                      np.asarray(b.quals)))
        pair_parts.append(np.asarray(p.pairs) + at)
        at += b.n_reads
    L = max(c.shape[1] for c, _, _ in parts)
    codes = np.full((at, L), 4, np.uint8)
    quals = np.zeros((at, L), np.uint8)
    lengths = np.zeros(at, np.int32)
    row = 0
    for c, ln, q in parts:
        codes[row:row + len(ln), :c.shape[1]] = c
        quals[row:row + len(ln), :q.shape[1]] = q
        lengths[row:row + len(ln)] = ln
        row += len(ln)
    return dict(codes=codes, lengths=lengths, quals=quals,
                pairs=np.concatenate(pair_parts))


def long_reads(g, coverage: float, seed: int, **kw) -> dict:
    """long_reads_orig's arrays: simulated PacBio reads, flat + offsets."""
    from allpathslg_tpu_torch.eval import sim

    lr, _, _ = sim.simulate_long_reads(g, coverage=coverage, seed=seed, **kw)
    offs = np.zeros(len(lr) + 1, np.int64)
    np.cumsum([len(r) for r in lr], out=offs[1:])
    return dict(bases=np.concatenate(lr), offsets=offs)


def write_assist_ref(path, g):
    """An assisting reference: a related strain of `g`, 0.3 % SNPs (the
    relative of tests/test_assisted.py), as FASTA at `path`."""
    from allpathslg_tpu_torch.eval import sim
    from allpathslg_tpu_torch.io import fasta

    fasta.write_fasta(str(path), [("relative",
                                   sim.mutate_genome(g, 0.003, seed=12))])


# Phase 9b's inputs, as tests/test_torch_full_long.py makes them: the
# reference's tests/test_repeat_longread_e2e.py (a 60 kb genome with a
# 2.5 kb exact repeat at 10,000 and 40,000; 50x fragment reads at 0.4 %
# error; 15x jump reads of 4000 +- 350; 12x PacBio of mean length 8000),
# a 6x long-jump library of 12000 +- 1200 and an assisting reference
LONG_GENOME, LONG_REPEAT, LONG_LOCI = 60_000, 2_500, (10_000, 40_000)
LONG_ARTIFACTS = CMP_ARTIFACTS + ("long_jump_reads_ec",
                                  "long_jump_alignlets")
LONG_STAGES = ("validate_inputs", "remove_dodgy", "precorrect",
               "find_errors", "clean_reads", "fill_fragments", "unipaths",
               "jump_ec", "align_jumps", "make_scaffolds",
               "long_jump_scaffolds", "align_frags", "patch_gaps",
               "long_read_patch", "assisted", "polish", "clean_final",
               "finalize", "submission_prep", "evaluate", "report")


def repeat_60kb():
    from allpathslg_tpu_torch.eval import sim

    g = sim.random_genome(LONG_GENOME, seed=71)
    a, b = LONG_LOCI
    g[b:b + LONG_REPEAT] = g[a:a + LONG_REPEAT]
    return g


def long_cmp_inputs() -> tuple:
    """(inputs for save_inputs, genome) of phase 9b."""
    from allpathslg_tpu_torch.eval import sim

    g = repeat_60kb()
    fb, fp, _ = sim.simulate_paired_reads(g, coverage=50, error_rate=0.004,
                                          seed=72)
    jb, jp, _ = sim.simulate_paired_reads(
        g, coverage=15, error_rate=0.004, insert_mean=4000, insert_sd=350,
        outward=True, seed=73)
    return {
        "frag_reads_orig": dict(codes=fb.codes, lengths=fb.lengths,
                                quals=fb.quals, pairs=fp.pairs),
        "jump_reads_orig": dict(codes=jb.codes, lengths=jb.lengths,
                                quals=jb.quals, pairs=jp.pairs,
                                lib_sep=np.array([4000], np.int32),
                                lib_sd=np.array([350], np.int32)),
        "long_jump_reads_orig": jump_libs([(g, 12000, 1200, 6.0, 75)]),
        "long_reads_orig": long_reads(g, 12, 74, mean_len=8000),
        "genome_truth": dict(genome=g),
    }, g


def diploid_inputs(hap1) -> dict:
    """Phase 10's inputs for haplotype 1 `hap1` (the reference's
    tests/test_scale_diploid_multilib.py): hap2 with 0.1 % SNPs; 30x
    fragment reads of each; jump libraries 3000 +- 300 at 12x from hap1
    and 6000 +- 600 at 10x from hap2; a long-jump library 12000 +- 1200 at
    6x and 5x PacBio, from hap1."""
    from allpathslg_tpu_torch.eval import sim

    hap2 = sim.mutate_genome(hap1, snp_rate=0.001, seed=22)
    return {
        "frag_reads_orig": mixed_frags((hap1, hap2), 30.0, (23, 24)),
        "genome_truth": dict(genome=hap1),
        "jump_reads_orig": jump_libs([(hap1, 3000, 300, 12.0, 25),
                                      (hap2, 6000, 600, 10.0, 26)]),
        "long_jump_reads_orig": jump_libs([(hap1, 12000, 1200, 6.0, 27)]),
        "long_reads_orig": long_reads(hap1, 5.0, 28),
    }


def phase_full_compare(tag: str, inputs: dict, overrides: dict,
                       artifacts, stages, must_launch, must_close=()):
    """run_full through the port on the card and on the CPU over the same
    inputs (save_inputs) with config `overrides`; checks that on the card
    each (stage, kernel) of `must_launch` launched and each stage of
    `must_close` closed at least one gap, and that every
    artifact of `artifacts`, every file of CMP_TEXT_FILES and every stage
    metric of `stages` is the same, byte for byte. Returns the card run's
    launches by stage."""
    from allpathslg_tpu_torch.ops.cuda import launches
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.stages import Pipeline

    rds = {}
    for device in ("cuda", "cpu"):
        run_dir = ROOT / "build" / f"chip_smoke_cmp_{device}"
        shutil.rmtree(run_dir, ignore_errors=True)
        rd = RunDir(str(run_dir))
        save_inputs(rd, inputs)
        pipe = Pipeline(rd, AssemblyConfig.from_overrides(**overrides),
                        lambda *a: None, device=device)
        launches.reset()
        t0 = time.perf_counter()
        pipe.run_full()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_stage = launches.by_stage()
        say(f"[{tag}] run_full on {device}: {wall:.1f} s; launches by "
            f"stage {by_stage}")
        if device == "cuda":
            card = by_stage
            for stage, kernel in must_launch:
                check(by_stage.get(stage, {}).get(kernel, 0) > 0,
                      f"[{tag}] run_full on the card never launched "
                      f"{kernel} in {stage}")
        rds[device] = rd
    gpu, cpu = rds["cuda"], rds["cpu"]
    for art in artifacts:
        a, b = gpu.load_arrays(art), cpu.load_arrays(art)
        check(sorted(a) == sorted(b), f"{art}: keys {sorted(a)} on the card, "
              f"{sorted(b)} on the CPU")
        for k in a:
            check(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                  and a[k].tobytes() == b[k].tobytes(),
                  f"{art}[{k}] differs between the card and the CPU")
    for name in CMP_TEXT_FILES:
        a = Path(gpu.file_path(name)).read_bytes()
        b = Path(cpu.file_path(name)).read_bytes()
        check(a and a == b, f"{name} differs between the card and the CPU")
    for stage in stages:
        check(gpu.metrics(stage) == cpu.metrics(stage),
              f"{stage} metrics differ: card {gpu.metrics(stage)}, CPU "
              f"{cpu.metrics(stage)}")
    closed = {s: gpu.metrics(s)["n_gaps_closed"] for s in stages
              if "n_gaps_closed" in gpu.metrics(s)}
    for stage in must_close:
        check(closed.get(stage, 0) >= 1, f"[{tag}] {stage} closed no gap")
    say(f"[{tag}] card == CPU: {len(artifacts)} artifacts, "
        f"{len(CMP_TEXT_FILES)} files and {len(stages)} stages' metrics "
        f"byte-identical; gaps closed {closed}")
    for rd in rds.values():
        shutil.rmtree(rd.path, ignore_errors=True)
    return card


def phase_long_compare():
    """Phase 9b: phase_full_compare on long_cmp_inputs with an assisting
    reference; long_read_patch must close a gap and launch the general
    kernel on the card."""
    inputs, g = long_cmp_inputs()
    ref = ROOT / "build" / "chip_smoke_relative.fasta"
    ref.parent.mkdir(parents=True, exist_ok=True)
    write_assist_ref(ref, g)
    card = phase_full_compare(
        "compare-long", inputs, dict(batch_reads=16384, assist_ref=str(ref)),
        LONG_ARTIFACTS, LONG_STAGES,
        [("long_read_patch", "banded_general")], ["long_read_patch"])
    ref.unlink()
    return card


class StageTimer:
    """Host wall time of calls to module attributes, by the pipeline stage
    of the calling thread: {(stage, "module.attr"): [seconds, calls]}.
    The timed functions return host arrays, so their time includes the
    card's."""

    def __init__(self, targets):
        import threading

        self.targets = targets          # [(module name, attribute)]
        self.totals = {}
        self._lock = threading.Lock()
        self._saved = []

    def install(self):
        import importlib

        from allpathslg_tpu_torch.ops.cuda import launches

        for module, attr in self.targets:
            mod = importlib.import_module(f"allpathslg_tpu_torch.{module}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _name=f"{module}.{attr}", **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    dt = time.perf_counter() - t0
                    key = (launches.current_stage(), _name)
                    with self._lock:
                        tot = self.totals.setdefault(key, [0.0, 0])
                        tot[0] += dt
                        tot[1] += 1

            setattr(mod, attr, wrapped)

    def remove(self):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []


DIPLOID_NEW_STAGES = ("long_jump_scaffolds", "long_read_patch", "assisted")
# long_read_patch's host anchoring (the read index, the flank votes) and
# its DP (the medoid and the consensus refinement; banded_align_host is
# the upload, the kernel and the download)
LONG_READ_TIMED = (("asm.longread", "LongReadIndex"),
                   ("asm.longread", "find_gap_segments"),
                   ("asm.longread", "consensus_patch"),
                   ("ops.banded", "banded_align_host"))
# Phase 10 keeps the largest (B x Lq x Lt) this many DP calls of a kernel
# in a stage: every medoid batch of long_read_patch has its own shape, and
# the plain version loops over its thousands of rows in Python; the
# largest DIPLOID_TIMED_GENERAL of them are timed
DIPLOID_KEEP_PER_STAGE = 8
DIPLOID_TIMED_GENERAL = 4


def phase_diploid(genome_size: int, capture: DPCapture):
    """Phase 10: run_full on the card over diploid_inputs of a repeat
    genome (REPEAT_FAMILIES) with an assisting reference, ploidy=2, with
    `capture` installed; returns each kernel's launches in the run."""
    from allpathslg_tpu_torch.eval import accuracy as eacc
    from allpathslg_tpu_torch.ops.cuda import launches
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.stages import Pipeline

    run_dir = ROOT / "build" / "chip_smoke_diploid"
    shutil.rmtree(run_dir, ignore_errors=True)
    rd = RunDir(str(run_dir))
    t0 = time.perf_counter()
    hap1 = repeat_genome(genome_size, 21)
    inputs = diploid_inputs(hap1)
    save_inputs(rd, inputs)
    ref = run_dir / "relative.fasta"
    write_assist_ref(ref, hap1)
    n_long = len(inputs["long_reads_orig"]["offsets"]) - 1
    say(f"[diploid] inputs: hap1 {genome_size} bp with REPEAT_FAMILIES, "
        f"hap2 0.1 % SNPs; {len(inputs['frag_reads_orig']['lengths'])} "
        f"fragment reads (30x each), "
        f"{len(inputs['jump_reads_orig']['lengths'])} jump reads (3 kb 12x "
        f"+ 6 kb 10x), {len(inputs['long_jump_reads_orig']['lengths'])} "
        f"long-jump reads (12 kb 6x), {n_long} PacBio reads (5x), "
        f"assist_ref 0.3 % SNPs: {time.perf_counter() - t0:.1f} s")

    cfg = AssemblyConfig.from_overrides(ploidy=2, assist_ref=str(ref))
    pipe = Pipeline(rd, cfg, lambda *a: None, device="cuda")
    timer = StageTimer(LONG_READ_TIMED)
    launches.reset()
    capture.install()
    timer.install()
    try:
        t0 = time.perf_counter()
        pipe.run_full()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        timer.remove()
        capture.remove()
    by_stage = launches.by_stage()
    total = {k: launches.count(k) for k in ("radix_sort", "banded_bp",
                                             "banded_general")}
    stages = rd.manifest["stages"]
    for stage in LONG_STAGES:
        rec = stages[stage]
        shown = {k: v for k, v in rec["metrics"].items() if k != "libraries"}
        say(f"[diploid] {stage}: {rec['elapsed_s']:.1f} s, launches "
            f"{by_stage.get(stage, {})}; {shown}")
    say(f"[diploid] run_full: {wall:.1f} s wall with stage_workers="
        f"{cfg.stage_workers}; launches {total}")
    for (stage, name), (secs, n) in sorted(timer.totals.items(), key=str):
        say(f"[diploid] {stage}: {name} {secs:.2f} s in {n} calls")

    m = {s: rd.metrics(s) for s in LONG_STAGES}
    for stage in DIPLOID_NEW_STAGES:
        check("skipped" not in m[stage], f"{stage} skipped: {m[stage]}")
    check(by_stage.get("long_read_patch", {}).get("banded_general", 0) > 0,
          "long_read_patch never launched the general kernel")
    check(by_stage.get("long_jump_scaffolds", {}).get("banded_bp", 0) > 0,
          "long_jump_scaffolds never launched the bit-parallel kernel")
    general_stages = sorted(s for s, c in by_stage.items()
                            if "banded_general" in c)
    lj, lr = m["long_jump_scaffolds"], m["long_read_patch"]
    check(lj["scaffold_n50"] >= m["make_scaffolds"]["scaffold_n50"],
          f"long-jump scaffold N50 {lj['scaffold_n50']} < make_scaffolds' "
          f"{m['make_scaffolds']['scaffold_n50']}")
    check(lr["n_gaps_closed"] >= 1, "long_read_patch closed no gap")
    check(lr["n_ambiguities_kept"] > 50,
          f"long_read_patch kept {lr['n_ambiguities_kept']} ambiguity "
          f"records (<= 50)")
    # evaluate counts a base covered only near a uniquely placed 32-mer,
    # so the repeat copies are never covered: the bar is 95 % of what the
    # truth genome itself covers as an assembly
    ceiling = eacc.evaluate(hap1, np.array([0, len(hap1)], np.int64), hap1,
                            device="cuda")["genome_covered_frac"]
    ev = m["evaluate"]
    check(ev["genome_covered_frac"] >= 0.95 * ceiling,
          f"genome covered {ev['genome_covered_frac']} < 0.95 x "
          f"{ceiling} (the truth's own)")
    for name in ("final.assembly.fasta", "final.assembly.efasta"):
        path = Path(rd.file_path(name))
        check(path.exists() and path.stat().st_size > 0, f"{name} missing")
    say(f"[diploid] general kernel launched in {general_stages}; "
        f"scaffold N50 {m['make_scaffolds']['scaffold_n50']} -> "
        f"{lj['scaffold_n50']} (long jumps); gaps closed patch_gaps "
        f"{m['patch_gaps']['n_gaps_closed']}, long_read_patch "
        f"{lr['n_gaps_closed']} ({lr['n_ambiguities_kept']} ambiguity "
        f"records kept), assisted {m['assisted']}; genome covered "
        f"{ev['genome_covered_frac']} (the truth's own {ceiling}), "
        f"misassembly breaks {ev['misassembly_breaks']}; finalize "
        f"n_ambiguities {m['finalize'].get('n_ambiguities')} (assisted "
        f"saves contigs_final without them, as the reference does); "
        f"final FASTA and EFASTA written")
    shutil.rmtree(run_dir, ignore_errors=True)
    return total


def phase_dp_diploid(capture: DPCapture, int_rate: float, chain: dict):
    """Phase 10's DP calls in the new stages: every kept call held against
    the plain version, exactly; timed in turns: the largest bit-parallel
    batch of long_jump_scaffolds and of long_read_patch, every general
    batch of assisted and the DIPLOID_TIMED_GENERAL largest of
    long_read_patch. Returns (max errors, bit-parallel timings by stage,
    general timings by stage)."""
    max_err = dp_calls_held(capture, "dp10", DIPLOID_NEW_STAGES)
    bp, general = {}, {"long_read_patch": [], "assisted": []}
    for stage in ("long_jump_scaffolds", "long_read_patch"):
        keys = [k for k in capture.kept if k[:2] == ("banded_bp", stage)]
        if keys:
            bp[stage] = dp_timed(capture, max(keys, key=lambda k: k[2] * k[3]),
                                 int_rate, chain, "dp10")
    lr = sorted((k for k in capture.kept
                 if k[:2] == ("banded_general", "long_read_patch")),
                key=lambda k: -k[2] * k[3] * k[4])
    for k in lr[:DIPLOID_TIMED_GENERAL]:
        general["long_read_patch"].append(
            dp_timed(capture, k, int_rate, chain, "dp10", plain_reps=1))
    for k in sorted(capture.kept, key=str):
        if k[:2] == ("banded_general", "assisted"):
            general["assisted"].append(dp_timed(capture, k, int_rate, chain,
                                                "dp10"))
    return max_err, bp, general


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-size", type=int, default=200_000,
                    help="genome of the contig-slice phase (7)")
    ap.add_argument("--full-genome-size", type=int, default=4_600_000,
                    help="genome of the run_full phase (8)")
    ap.add_argument("--diploid-genome-size", type=int, default=500_000,
                    help="haplotype of the diploid run_full phase (10)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script only runs "
                         "on a GPU")
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    t_phase = [t_start]

    def done(phase: str):
        now = time.perf_counter()
        say(f"[phase] {phase}: {now - t_phase[0]:.1f} s (total "
            f"{now - t_start:.1f} s)")
        t_phase[0] = now

    name, int_rate = phase_card()
    phase_build()
    chain = chain_terms()
    done("1-2 card, build, chain")
    codes = flagship_codes(args.seed)
    record = phase_sort(codes, args.seed)
    done("3 sort")
    phase_spectrum(codes)
    done("4 spectrum")
    set_a_record = phase_banded(args.seed, int_rate)
    done("5 bit-parallel DP")
    general_record = phase_banded_general(args.seed, int_rate, chain)
    done("6 general DP")
    slice_launches = phase_slice(args.genome_size, args.seed)
    done("7 contig slice")
    capture = DPCapture()
    full_launches = phase_full(args.full_genome_size, args.seed, capture)
    bp_record, general_full = phase_dp_batches(capture, int_rate, chain)
    done("8 run_full")
    phase_full_compare("compare", cmp_inputs(), dict(batch_reads=4096),
                       CMP_ARTIFACTS, FULL_STAGES,
                       [("patch_gaps", "banded_general")])
    done("9 card == CPU")
    phase_long_compare()
    done("9b card == CPU, long reads")
    capture10 = DPCapture(keep_per_stage=DIPLOID_KEEP_PER_STAGE)
    diploid_launches = phase_diploid(args.diploid_genome_size, capture10)
    err10, bp10, general10 = phase_dp_diploid(capture10, int_rate, chain)
    done("10 diploid multi-library run_full")
    bp_record["max_abs_err"] = max(bp_record["max_abs_err"],
                                   set_a_record.pop("max_abs_err"),
                                   err10["banded_bp"])
    general_record["max_abs_err"] = max(general_record["max_abs_err"],
                                        general_full.pop("max_abs_err"),
                                        err10["banded_general"])
    for stage, tag in (("long_jump_scaffolds", "long_jump"),
                       ("long_read_patch", "long_read")):
        if stage in bp10:
            bp_record.update({f"{tag}_{k}": v for k, v in bp10[stage].items()})
    for stage, tag in (("long_read_patch", "long_read"),
                       ("assisted", "assisted")):
        general_record.update({
            f"{tag}_{k}s" if k == "shape" else f"{tag}_{k}":
            [g[k] for g in general10[stage]]
            for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")})
    say(json.dumps({"kernels": [{
        "name": "radix_sort_u64", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/radix_sort.cu",
        "replaces": "allpathslg_tpu/ops/pallas/sort_pallas.py:178",
        "launches": (slice_launches["sort"] + full_launches["radix_sort"]
                     + diploid_launches["radix_sort"]),
        **record}, {
        "name": "banded_bp", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/banded_bp.cu",
        "replaces": "allpathslg_tpu/ops/pallas/banded_bp.py:294",
        "launches": (slice_launches["banded"] + full_launches["banded_bp"]
                     + diploid_launches["banded_bp"]),
        **bp_record, **set_a_record}, {
        "name": "banded_general", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/banded_general.cu",
        "replaces": "allpathslg_tpu/ops/pallas/banded_pallas.py:127",
        "launches": (full_launches["banded_general"]
                     + diploid_launches["banded_general"]),
        **general_record,
        **general_full}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (allpathslg_tpu_torch).

    python3 chip_smoke.py [--genome-size N] [--full-genome-size N]
                          [--diploid-genome-size N] [--seed S]
                          [--only 7,8,9,9b,10,11,12,13,14]

Needs one CUDA GPU (it raises without one) and `nvcc`; it imports nothing
of JAX or of the JAX package. Phases, each printed as it ends:

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the five Hopper kernels, the radix sort (csrc/radix_sort.cu),
     the batched row sort (csrc/row_sort.cu), the bit-parallel banded DP
     (csrc/banded_bp.cu), the general banded DP (csrc/banded_general.cu)
     and polish's pileup (csrc/pileup.cu), and the chain probes
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
     (one count_reads batch of 65,536 x 100 bp), 65,536 keys and the
     mesh shards' 2**19, 2**20 and 2**21 keys, the passes planned, the
     bytes moved against the LSD floor, and median times in turns of
     plain version, kernel and torch.sort;
  4. spectrum_step(K=24) on the same batch, against the CPU spectrum
     (kept for phase 11);
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
 6b. polish's pileup kernel (csrc/pileup.cu) on pileup_reads, the shape
     of a 400 kb assembly (~88,000 placed reads of 101-203 bases): its
     votes against the plain version's, exactly, in one segment, and
     polish's segment loop on the card against the CPU in 7 segments of
     PILEUP_SEG (one launch each); the kernel's device time (device_ms)
     against its byte bound (pileup_bound_ms), and a whole pass of
     polish's pileup on the card and on the CPU;
  7. the contig slice and align_frags through Pipeline(device="cuda")
     with profile_dir set, so every stage runs under torch.profiler (CPU
     and CUDA activities) and writes its Chrome trace:
     prepare_sim_inputs -> validate_inputs -> remove_dodgy -> precorrect
     -> find_errors -> clean_reads -> fill_fragments -> unipaths ->
     report -> align_frags on a simulated genome (--genome-size, default
     200 kb, 100x fragment coverage, 100 bp reads, 0.5 % error, seed 0,
     batch_reads 65536), with each stage's (traced) wall time and kernel
     launches. It checks that every stage wrote a trace, that the traces
     of validate_inputs, precorrect, find_errors and unipaths name the
     radix sort's kernels (SORT_KERNEL_NAMES), that the sort kernel ran in
     those stages and the banded kernel in align_frags; that
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
     families like an E. coli chromosome (REPEAT_FAMILIES), from files:
     the simulated reads are written with numpy (write_fastq,
     write_pairs_sam) as the fragment library's mate files frag_1.fastq
     and frag_2.fastq (named in in_groups.csv by frag_?.fastq), the jump
     library as one SAM with paired flags (every odd pair's second mate
     reverse-complemented, flag 0x10) and in_libs.csv / in_groups.csv
     (write_sheets), then imported by pipeline/prepare.prepare_inputs
     (the native FASTQ reader; the per-line SAM parse); every imported
     pair must hold the simulated pair's two reads (codes, quals,
     lengths), and the seconds of writing, reading FASTQ, reading SAM and
     prepare_inputs are printed. It prints each
     stage's wall time from the manifest and each kernel's launches by
     stage, and checks that the general kernel ran, in patch_gaps only;
     that the pileup kernel ran in polish only, once a pass (2, or 3 when
     an indel was fixed);
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
  9. run_full through the port's CLI, pipeline.run.main with --in-libs /
     --in-groups, check_mode=true, evaluation=CHEAT and batch_reads=4096,
     once with --device cuda and once with --device cpu (the CPU's runs
     of phases 9 and 9b are made by a child process that sees no card,
     cpu_runs, started before phase 8 and waited for after it), over
     tests/test_torch_full.py's 40 kb genome with a two-copy 2.5 kb
     repeat (40x fragment, 15x jump reads of 4000 +- 350; cmp_inputs)
     with N bases drawn from the seed (with_n_bases: 0.1 % of bases, and
     1 % of reads ending in a run of 5-10 N), written as files as in
     phase 8, genome_truth in each run dir: check_mode's spectrum must
     launch the sort kernel and patch_gaps the general kernel on the
     card, each run must log the check line and two CHEAT lines, and
     every file (arrays key by key), every stage metric (the cheat_*
     ones included) and the check/CHEAT log lines must be the same
     (run_dir_diff); the card run's every bit-parallel call is captured
     and held against its plain version, and counted against the CPU's
     route, where a query N matches a target pad (query_n_split); a
     difference is allowed only in CLI_N_SPLIT_MAY_DIFFER and only where
     that split shows;
 9b. the same on tests/test_torch_full_long.py's inputs (long_cmp_inputs:
     the reference's tests/test_repeat_longread_e2e.py 60 kb genome with
     a 2.5 kb repeat, 50x fragment, 15x jump and 12x PacBio reads, plus a
     6x long-jump library of 12000 +- 1200 and an assisting reference of
     0.3 % SNPs; batch_reads 16384): long_jump_scaffolds, long_read_patch
     and assisted run, long_read_patch must launch the general kernel on
     the card, and LONG_ARTIFACTS, CMP_TEXT_FILES and LONG_STAGES' metrics
     must be byte-identical;
 10. `Pipeline(device="cuda").run_full()` over the reference's diploid
     multi-library configuration (diploid_inputs, from
     tests/test_scale_diploid_multilib.py, 500 kb there; ploidy=2) with
     haplotype 1 a repeat genome of --diploid-genome-size (REPEAT_FAMILIES;
     250 kb by default, which keeps the whole smoke inside its limit) and an
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
 11. the tools CLI on the card (phase_tools, tools.main with its stdout
     captured): kspec on the flagship batch written as FASTQ at K=24
     (the spectrum it computes must equal phase 4's); align at bench.py's
     lookup shape (a 2 Mb genome in 16 contigs as FASTA, the first 65,536
     reads of a 3.3x library at 1 % error as FASTQ): >= 90 % of the reads
     that lie inside one contig placed at their true contig, position and
     strand, and the bit-parallel kernel launched in the rescue;
     longproto on a 100 kb region with 50x of 250 bp pairs, insert 450
     +- 20, 0.4 % error: its longest contig covers >= 90 % of the region,
     and the sort kernel launched in friend finding and in counting
     (LaunchStages). Each subcommand's seconds and launches are printed.
 12. the library modules on the card (phase_library), each plain torch
     on the device but for Ultra's friend sort and the ulinks chain's
     sorts (the Hopper radix sort): (a) ops/affine at bench.py's DP shape
     (16,384 x 100 x 140) at band 16 on dp_problems (ragged, rows with no
     in-band path): the card == the CPU (cost, t_end), the numpy oracle
     on 64 rows; (b) align/mxu_scan: 1,024 reads of 100 bp with 0-3
     substitutions, both strands, ragged, on a 1 Mb target, each found at
     its planted place by imperfect_lookup and, when exact, as the one hit
     of perfect_lookup; match_counts == an integer count on 64 reads; 256
     reads of 300 bp on 200 kb (counts above 256): match_counts == an
     integer count, both lookups card == CPU; times and peak memory
     printed; (c) graph/ulinks on repeat_genome(1 Mb): count
     and build_unipaths of error-free 100 bp tiles on the card, path_reads
     of 40x jump pairs of 3000 +- 300, build_ulink_graph (>= 2**14 keys
     through the native radix sort, native/radix_sort.cpp) and the
     neighbourhoods of the CN=1 seeds; at 200 kb the whole chain on the
     card == on the CPU byte for byte; (d) long/ultra: the reference's
     done-criterion (tests/test_ultra.py: 15x CLR of mean 5 kb at 15 %
     error, 3 rounds, LongProto on 250 bp tiles: clean 24-mers > 0.70, a
     total within 0.7-1.5 x the genome, 100-mers covered > 0.80) at 60 kb
     (200 kb took the whole smoke past 1,000 s; scripts/ultra_criterion.py
     runs it at any size), its seconds split into friend sort, hit
     selection, problem build, DP forward, traceback and consensus; at 20
     kb with 2 rounds the card == the CPU byte for byte. The plain
     programs' kernel launches and device time come from torch.profiler
     (kernel_rows), which must record some. Each part prints its seconds.
 13. the mesh (parallel/*) on the card, every shard of an 8-shard mesh
     (MESH_SHARDS) on it (phase_mesh): (a) at the flagship shape,
     distributed_spectrum's spectrum == phase 4's with dropped 0 and the
     n_unique summing to the distinct count; sample_sort of the 16,646,144
     two-word keys with an int32 payload == ops/sort.sort_by_words on the
     card once the sentinels are stripped in shard order; sample_sort on
     the card == on a CPU mesh (plain sort) over 2**20 keys, every array;
     ring_segmented_cumsum over 8 x 2**20 int32 (two shards without a
     start) == segment_cumsum; each leg timed (median of
     MESH_TIMING_REPS) beside its 1-device call; (b) phase 8's run dir
     copied (artifacts hard-linked), the records and outputs of
     validate_inputs, find_errors, clean_reads and unipaths dropped, those
     stages run with n_devices=8 on the card: every file they write ==
     phase 8's (arrays key by key) and their metrics equal, each stage's
     seconds beside phase 8's and the all_to_all byte model
     (last_ici_bytes); (c) two processes of 4 shards each on the card
     over gloo (exchanges staged through host memory, multihost) hold the
     flagship batch's spectrum against phase 4's. The sort's launches in
     (a)'s first calls, (b) and (c) are counted, with their key counts.

 14. the count engines (phase_count_engines): (a) the batched row sort
     against its plain version (row_sort_plain), exactly, on random 1- and
     2-word keys with 1 % all-ones at the four shapes grouping_plan gives
     the flagship batch (ROW_SORT_SHAPES: 127 x 131,072 tiles and 127 x
     196,723 slabs at K=24, 55 x 131,072 and 55 x 196,625 at K=96), on
     the flagship's own K=24 tiles (also with an initial index, and its
     histogram and bases kernels against theirs), on odd rows of 1 and 3,
     on rows all sentinels and on row_sort_hard_cases (4,096 rows of one
     tile, rows ending mid-tile, rows of one key, K=24 keys, sentinel
     rows; each also with an initial index); each shape timed in turns
     beside the plain version and torch.sort(dim=1), with its byte bound,
     and the flagship tiles' device ms split by kernel; (b) spectrum_reads_auto with
     APLG_COUNT_ENGINE=bucketed on the flagship batch: its spectrum ==
     phase 4's, two row sorts and one sample sort launched (the bucketed
     path, no flat fallback), max_run <= slots; count_grouped's table,
     compacted, == count_sorted's; (c) the same tables at K=96 (6-word
     keys); (d) count_grouped on the card == on the CPU, every array, at
     2**20 keys: K=24 keys, 7 x 3 distinct keys (the retry) and one
     repeated key (the flat fallback), the attempt that returned printed;
     (e) `python -m allpathslg_tpu_torch.tune_count --dry` in a child
     process: both engines' ms a batch and M k-mers/s on this card, and
     no tuning file written.

With --only, phases 1-6b and the listed ones run (a rehearsal; 13 runs 8
first, whose run dir it reuses); without it, every phase. Each phase prints its seconds. Any failed check raises,
so the exit code is not 0. The line before the last is the kernel record {"kernels":
[...]}, whose `launches` are each kernel's launches in the pipeline
phases 7, 8, 9 (the card's run), 9b (the card's run) and 10, the tools
phase 11, the library phase 12 (the radix sort in ulinks' chain and in
Ultra's friend finding), the mesh phase 13 and the count engines' phase
14 ((b) and (c)), each counted from 0 just
before its phase (the sort's record adds the key-count histograms of
phases 8 and 13 by power of two, phase8_sorts_under_2**17 and the mesh
legs' times), and
whose
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
row sort's ms, plain_ms, library_ms and bound_ms are those of the
flagship's K=24 tiles (127 x 131,072), with each shape of (a) under
`shapes`, its device ms by kernel under split_*_ms, and the tuner's two
engines beside them. The pileup's ms and bound_ms are phase 6b's one
segment of 400 kb, with pass_ms and plain_pass_ms a whole pass on the
card and on the CPU. The
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

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
                                               chain_probe, nvcc,
                                               pileup_cuda, row_sort_cuda,
                                               sort_cuda)

    mods = (sort_cuda, row_sort_cuda, banded_cuda, banded_general_cuda,
            chain_probe, pileup_cuda)
    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(lambda m: nvcc.build(m._SOURCE), mods))
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


MESH_SHARD_KEY_BITS = (19, 20, 21)   # phase 13's shard sorts: 2**19-2**21


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
             ("small", key[:65_536].clone()),
             *((f"a mesh shard's 2**{b}", key[:1 << b].clone())
               for b in MESH_SHARD_KEY_BITS))
    check(sizes[1][1].numel() == 5_046_272,
          f"batch key count {sizes[1][1].numel()}")
    record = {}
    mesh_sizes = {}
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
        timed = {"ms": kern, "plain_ms": pl, "library_ms": lib,
                 "bound_ms": bound_ms, "bound_by": "bytes"}
        if not record:
            record = timed
        elif label.startswith("a mesh shard"):
            mesh_sizes[str(m)] = timed
    return {"max_abs_err": max_err, **record, "mesh_shard_sizes": mesh_sizes}


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
    return cspec


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
            reps = 1 if kind == "medoid" else TIMING_REPS
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


# Phase 6b: polish's pileup at the shape of a 400 kb assembly
PILEUP_GENOME, PILEUP_READS, PILEUP_LEN = 400_000, 90_000, 203
PILEUP_SEG = 65_536   # the across-segments check: 7 segments, one ragged


def pileup_reads(genome_size: int, n: int, L: int, seed: int):
    """polish's pileup inputs (offsets, codes, lengths, contig, anchor, rc,
    ok): contigs of 4-24 kb summing to genome_size, n reads of L/2 to L
    bases placed on them, half reverse-complemented, 3 % of bases N-like,
    98 % placed (the others with a contig and an anchor no contig has)."""
    rng = np.random.default_rng(seed)
    cl = rng.integers(4_000, 24_000, max(1, genome_size // 13_000))
    cl = np.maximum(cl * genome_size // cl.sum(), 1).astype(np.int64)
    offsets = np.zeros(len(cl) + 1, np.int64)
    np.cumsum(cl, out=offsets[1:])
    lengths = rng.integers(L // 2, L + 1, n).astype(np.int32)
    contig = rng.integers(0, len(cl), n).astype(np.int32)
    hi = np.maximum(cl[contig] - lengths, 1)
    start = (rng.random(n) * hi).astype(np.int64)
    rc = rng.random(n) < 0.5
    anchor = np.where(rc, start + lengths - 1, start).astype(np.int32)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.03] = 4
    ok = rng.random(n) < 0.98
    contig[~ok] = -1
    anchor[~ok] = 2**31 - 1
    return offsets, codes, lengths, contig, anchor, rc, ok


def pileup_bound_ms(lengths, ok, row_len: int, columns: int) -> float:
    """The pileup kernel's least time: its bytes over 3.35 TB/s, each base
    of a placed read read once, 13 B of alignlet a placed read (length,
    contig, anchor, rc) and 16 B a column written."""
    placed = np.minimum(np.asarray(lengths)[np.asarray(ok)], row_len)
    nbytes = int(placed.sum()) + 13 * len(placed) + 16 * columns
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_pileup(seed: int) -> dict:
    """Phase 6b: the pileup kernel (csrc/pileup.cu) on pileup_reads at
    400 kb. Its votes must equal the plain version's, exactly, in one
    segment and through polish's segment loop in PILEUP_SEG segments (one
    launch a segment). Then its device time (device_ms) against its bound,
    and a whole pass of polish's pileup (the host sort and gather, the
    copies up, the kernel, the votes back) on the card and on the CPU."""
    from allpathslg_tpu_torch import trace
    from allpathslg_tpu_torch.asm import polish
    from allpathslg_tpu_torch.ops.cuda import pileup_cuda

    arrays = pileup_reads(PILEUP_GENOME, PILEUP_READS, PILEUP_LEN, seed)
    offsets, codes, lengths, contig, anchor, rc, ok = arrays
    total = int(offsets[-1])
    ids, starts = polish._placed_by_start(offsets, lengths, contig, anchor,
                                          rc, ok)
    dargs = polish._pileup_inputs(*arrays[:-1], ids, starts, device="cuda")
    got = pileup_cuda.pileup(*dargs, 0, total).cpu()
    want = pileup_cuda.pileup_plain(*[a.cpu() for a in dargs], 0, total)
    err = int((got - want).abs().max())
    check(err == 0, f"pileup kernel != plain version at {total} columns: "
          f"max abs err {err}")
    trace.reset()
    card = polish._pileup_votes(*arrays, seg=PILEUP_SEG, device="cuda")
    launches = trace.count("pileup")
    cpu = polish._pileup_votes(*arrays, seg=PILEUP_SEG, device="cpu")
    n_seg = -(-total // PILEUP_SEG)
    check(np.array_equal(card, cpu), f"polish's pileup in {n_seg} "
          f"segments: card != CPU")
    check(launches == n_seg, f"{launches} pileup launches for {n_seg} "
          f"segments")
    ms = device_ms(lambda: pileup_cuda.pileup(*dargs, 0, total))
    bound = pileup_bound_ms(lengths, ok, PILEUP_LEN, total)

    def pass_ms(device, reps):
        took = []
        for _ in range(reps):
            t0 = time.perf_counter()
            polish._pileup_votes(*arrays, device=device)
            took.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(took))

    pass_card = pass_ms("cuda", 10)
    pass_cpu = pass_ms("cpu", 3)
    say(f"[pileup] {total} columns, {len(ids)} of {len(lengths)} reads "
        f"placed, rows of {PILEUP_LEN}: kernel == plain (one segment); "
        f"card == CPU in {n_seg} segments, {launches} launches; kernel "
        f"{ms:.4f} ms, bound {bound:.4f} ms (bytes), "
        f"{bound / ms * 100:.1f} % of it; a pass {pass_card:.1f} ms on the "
        f"card, {pass_cpu:.1f} ms on the CPU (plain)")
    return {"shape": [total, len(ids), PILEUP_LEN], "max_abs_err": err,
            "ms": ms, "bound_ms": bound, "bound_by": "bytes",
            "pass_ms": pass_card, "plain_pass_ms": pass_cpu,
            "segment_launches": launches}


SLICE_STAGES = ("validate_inputs", "remove_dodgy", "precorrect",
                "find_errors", "clean_reads", "fill_fragments", "unipaths",
                "report", "align_frags")


# the radix sort's kernels as torch.profiler names them (csrc/radix_sort.cu)
SORT_KERNEL_NAMES = ("histogram_kernel", "onesweep_pass_kernel")


def phase_slice(genome_size: int, seed: int):
    """The contig slice and align_frags through Pipeline(device="cuda")
    with profile_dir set: each stage under torch.profiler, its trace
    checked; returns each kernel's launches in the run."""
    from allpathslg_tpu_torch import trace
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
    trace_dir = run_dir / "trace"
    cfg = AssemblyConfig.from_overrides(profile_dir=str(trace_dir))

    def log(msg: str):  # the unipaths stage's own step times
        if msg.startswith("  [unipaths]"):
            say(f"[slice] {msg.strip()}")

    pipe = Pipeline(rd, cfg, log, device="cuda")
    kernels = {"sort": "radix_sort", "banded": "banded_bp"}
    for name in kernels.values():
        trace.reset(name)
    metrics, launches = {}, {}
    for stage in SLICE_STAGES:
        before = {k: trace.count(n) for k, n in kernels.items()}
        t = time.perf_counter()
        metrics[stage] = getattr(pipe, stage)()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[stage] = {k: trace.count(n) - before[k]
                           for k, n in kernels.items()}
        shown = {k: v for k, v in metrics[stage].items() if k != "libraries"}
        say(f"[slice] {stage}: {dt:.1f} s, kernel launches "
            f"sort {launches[stage]['sort']}, banded "
            f"{launches[stage]['banded']}; {shown}")
    total = {k: trace.count(n) for k, n in kernels.items()}
    traces = {}
    for stage in SLICE_STAGES:
        path = trace_dir / stage / "trace.json"
        check(path.exists(), f"profile_dir: {stage} wrote no trace")
        text = path.read_text()
        check('"traceEvents"' in text, f"{path} is not a Chrome trace")
        traces[stage] = (path.stat().st_size,
                         {k: text.count(k) for k in SORT_KERNEL_NAMES})
    say(f"[slice] profile_dir: a torch.profiler trace a stage (MB; sort "
        f"kernel names in it): " + "; ".join(
            f"{st} {size / 1e6:.1f} ({names})"
            for st, (size, names) in traces.items()))
    for stage in ("validate_inputs", "precorrect", "find_errors",
                  "unipaths"):
        check(launches[stage]["sort"] > 0,
              f"{stage} never launched the sort kernel")
        check(all(traces[stage][1].values()),
              f"the trace of {stage} names no radix-sort kernel "
              f"{traces[stage][1]}")
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


# ---- real-read files, written with numpy (phases 8, 9 and 11) ----
ASCII_BASES = np.frombuffer(b"ACGTN", np.uint8)
ROWS_A_CHUNK = 1 << 19
LIB_HEADER = ("library_name,project_name,organism_name,type,paired,"
              "frag_size,frag_stddev,insert_size,insert_stddev,"
              "read_orientation,genomic_start,genomic_end\n")


def _digits(values, width: int) -> np.ndarray:
    """uint8 [n, width]: values as zero-padded decimal ASCII."""
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (np.asarray(values, np.int64)[:, None] // pw % 10
            + 48).astype(np.uint8)


def _text(n: int, text: bytes) -> np.ndarray:
    return np.tile(np.frombuffer(text, np.uint8), (n, 1))


def write_fastq(path, codes, quals, name: bytes, rows=None):
    """Reads of one length (those of `rows`, else all) as FASTQ records
    `@{name}{i:09d}`, built as byte matrices (one row a record) a chunk of
    reads at a time."""
    rows = np.arange(len(codes)) if rows is None else np.asarray(rows)
    with open(path, "wb") as f:
        for s in range(0, len(rows), ROWS_A_CHUNK):
            pick = rows[s:s + ROWS_A_CHUNK]
            c, q = np.asarray(codes)[pick], np.asarray(quals)[pick]
            m = len(c)
            f.write(np.concatenate([
                _text(m, b"@" + name), _digits(np.arange(s, s + m), 9),
                _text(m, b"\n"), ASCII_BASES[np.minimum(c, 4)],
                _text(m, b"\n+\n"), (q + 33).astype(np.uint8),
                _text(m, b"\n")], axis=1).tobytes())


def write_pairs_sam(path, codes, quals, pairs, name: bytes):
    """Read pairs of one length as unaligned SAM records: each pair's
    mates in turn with flags 0x1|0x40 and 0x1|0x80, the second mate of
    every odd pair stored reverse-complemented with 0x10 (io/sam.read_sam
    restores its sequenced orientation)."""
    with open(path, "wb") as f:
        f.write(b"@HD\tVN:1.6\tSO:unsorted\n")
        for s in range(0, len(pairs), ROWS_A_CHUNK):
            p = np.asarray(pairs[s:s + ROWS_A_CHUNK])
            m = len(p)
            qname = np.concatenate([_text(m, name),
                                    _digits(np.arange(s, s + m), 9)], axis=1)
            rc = (np.arange(s, s + m) % 2 == 1)[:, None]
            c1, q1 = codes[p[:, 1]], quals[p[:, 1]]
            c1 = np.where(rc, np.where(c1[:, ::-1] < 4, 3 - c1[:, ::-1], 4),
                          c1)
            q1 = np.where(rc, q1[:, ::-1], q1)
            recs = []
            for c, q, flag in ((codes[p[:, 0]], quals[p[:, 0]],
                                _text(m, b"65")),
                               (c1, q1, _digits(0x81 | 0x10 * rc[:, 0], 3))):
                recs += [qname, _text(m, b"\t"), flag,
                         _text(m, b"\t*\t0\t0\t*\t*\t0\t0\t"),
                         ASCII_BASES[np.minimum(c, 4)], _text(m, b"\t"),
                         (q + 33).astype(np.uint8), _text(m, b"\n")]
            f.write(np.concatenate(recs, axis=1).tobytes())


def write_sheets(d: Path, frag, jump):
    """in_libs.csv (the reference's columns) and in_groups.csv for a
    fragment library in mate files frag_1.fastq / frag_2.fastq (named by
    the frag_?.fastq wildcard) and a jump library in jump.sam; frag and
    jump are (insert, sd)."""
    (d / "in_libs.csv").write_text(
        LIB_HEADER
        + f"frag,smoke,sim,fragment,1,{frag[0]},{frag[1]},,,inward,,\n"
        + f"jump,smoke,sim,jumping,1,,,{jump[0]},{jump[1]},outward,,\n")
    (d / "in_groups.csv").write_text(
        "group_name,library_name,file_name\n"
        "frag,frag,frag_?.fastq\n"
        "jump,jump,jump.sam\n")


def write_read_files(d: Path, frag: dict, jump: dict, frag_lib, jump_lib):
    """The files a user would hand the port: frag {codes, quals, pairs} as
    mate FASTQs, jump as one SAM, and the sheets. Returns seconds."""
    t0 = time.perf_counter()
    d.mkdir(parents=True, exist_ok=True)
    for mate in (0, 1):
        write_fastq(d / f"frag_{mate + 1}.fastq", frag["codes"],
                    frag["quals"], b"f", np.asarray(frag["pairs"])[:, mate])
    write_pairs_sam(d / "jump.sam", np.asarray(jump["codes"]),
                    np.asarray(jump["quals"]), np.asarray(jump["pairs"]),
                    b"j")
    write_sheets(d, frag_lib, jump_lib)
    return time.perf_counter() - t0


def check_imported_pairs(rd, art: str, sim: dict, tag: str):
    """Every pair of artifact `art` (as prepare_inputs saved it) holds the
    two reads of the simulated pair of the same rank: codes, quals and
    lengths exactly."""
    a = rd.load_arrays(art, mmap=True)
    got_pairs, want_pairs = np.asarray(a["pairs"]), np.asarray(sim["pairs"])
    check(got_pairs.shape == want_pairs.shape,
          f"[{tag}] {art}: {len(got_pairs)} pairs imported, "
          f"{len(want_pairs)} simulated")
    for s in range(0, len(got_pairs), ROWS_A_CHUNK):
        for mate in (0, 1):
            got = got_pairs[s:s + ROWS_A_CHUNK, mate]
            want = want_pairs[s:s + ROWS_A_CHUNK, mate]
            for key in ("codes", "quals", "lengths"):
                x, y = np.asarray(a[key])[got], np.asarray(sim[key])[want]
                check(x.shape == y.shape and np.array_equal(x, y),
                      f"[{tag}] {art}: imported {key} differ from the "
                      f"simulated pair's (pairs {s}..)")


INSERT, INSERT_SD = 3000, 300
FRAG_INSERT, FRAG_SD = 180, 18     # eval/sim.simulate_paired_reads' default


def full_inputs(rd, genome_size: int, seed: int):
    """Run_full's inputs in run dir `rd`, from files: the repeat genome,
    100x fragment reads and 50x jump reads of INSERT +- INSERT_SD (100 bp,
    0.5 % error, from `seed`) written as mate FASTQs, one SAM and library
    sheets, then imported by pipeline/prepare.prepare_inputs; every
    imported pair is checked against the simulated one. genome_truth is
    saved for evaluate."""
    from allpathslg_tpu_torch.eval import sim
    from allpathslg_tpu_torch.pipeline.prepare import prepare_inputs

    t0 = time.perf_counter()
    g = repeat_genome(genome_size, seed)
    fb, fp, _ = sim.simulate_paired_reads(g, coverage=100.0, read_len=100,
                                          error_rate=0.005, seed=seed + 1)
    jb, jp, _ = sim.simulate_paired_reads(
        g, coverage=50.0, read_len=100, error_rate=0.005, insert_mean=INSERT,
        insert_sd=INSERT_SD, outward=True, seed=seed + 2)
    frag = dict(codes=np.asarray(fb.codes), quals=np.asarray(fb.quals),
                lengths=np.asarray(fb.lengths), pairs=np.asarray(fp.pairs))
    jump = dict(codes=np.asarray(jb.codes), quals=np.asarray(jb.quals),
                lengths=np.asarray(jb.lengths), pairs=np.asarray(jp.pairs))
    t_sim = time.perf_counter() - t0
    files = Path(rd.path) / "reads"
    t_write = write_read_files(files, frag, jump, (FRAG_INSERT, FRAG_SD),
                               (INSERT, INSERT_SD))
    sizes = {p.name: p.stat().st_size for p in files.iterdir()}
    timer = StageTimer((("io.native_fastq", "read_fastq_arrays"),
                        ("io.sam", "read_sam")))
    timer.install()
    try:
        t0 = time.perf_counter()
        counts = prepare_inputs(rd, str(files / "in_libs.csv"),
                                str(files / "in_groups.csv"),
                                log=lambda *a: None)
        t_prep = time.perf_counter() - t0
    finally:
        timer.remove()
    shutil.rmtree(files)
    reads = {name: secs for (_, name), (secs, _) in timer.totals.items()}
    t0 = time.perf_counter()
    check_imported_pairs(rd, "frag_reads_orig", frag, "full")
    check_imported_pairs(rd, "jump_reads_orig", jump, "full")
    t_check = time.perf_counter() - t0
    del frag, jump, fb, jb
    rd.save_arrays("genome_truth", genome=g)
    say(f"[full] inputs: genome {genome_size} bp with repeat families "
        f"{REPEAT_FAMILIES}; {counts['frag_reads_orig']} fragment reads "
        f"(100x), {counts['jump_reads_orig']} jump reads (50x, {INSERT} +- "
        f"{INSERT_SD}); simulated {t_sim:.1f} s")
    say(f"[full] ingest: wrote {sizes} (bytes) in {t_write:.1f} s; "
        f"prepare_inputs {t_prep:.1f} s, of which reading FASTQ (native "
        f"reader) {reads['io.native_fastq.read_fastq_arrays']:.1f} s and "
        f"SAM (per-line parse, as the reference) "
        f"{reads['io.sam.read_sam']:.1f} s; every imported pair == its "
        f"simulated pair (codes, quals, lengths): {t_check:.1f} s")


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

        from allpathslg_tpu_torch import trace

        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            q, t = a["q"], a["t"]
            kw = {k: a[k] for k in ("band", "sub_cost", "gap_cost") if k in a}
            key = (kernel, trace.current_stage(), q.shape[0], q.shape[1],
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


FULL_DIR = ROOT / "build" / "chip_smoke_full"


def phase_full(genome_size: int, seed: int, capture: DPCapture,
               keep: bool = False):
    """run_full on the card at the binding libraries over a repeat-bearing
    genome, with `capture` installed around it; returns each kernel's
    launches in the run and the sort's key-count histogram. With `keep`
    the run dir (FULL_DIR) stays for phase 13."""
    from allpathslg_tpu_torch.eval import stats
    from allpathslg_tpu_torch import trace
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.stages import Pipeline
    from allpathslg_tpu_torch.scaffold import superb

    run_dir = FULL_DIR
    shutil.rmtree(run_dir, ignore_errors=True)
    rd = RunDir(str(run_dir))
    full_inputs(rd, genome_size, seed)

    cfg = AssemblyConfig.from_overrides()
    pipe = Pipeline(rd, cfg, lambda *a: None, device="cuda")
    trace.reset()
    capture.install()
    try:
        t0 = time.perf_counter()
        pipe.run_full()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        capture.remove()
    by_stage = trace.by_stage()
    total = {k: trace.count(k) for k in ("radix_sort", "banded_bp",
                                             "banded_general", "pileup")}
    sizes = sorted_histogram(trace.size_histogram("radix_sort"))
    stages = rd.manifest["stages"]
    for stage in FULL_STAGES:
        rec = stages[stage]
        shown = {k: v for k, v in rec["metrics"].items() if k != "libraries"}
        say(f"[full] {stage}: {rec['elapsed_s']:.1f} s, launches "
            f"{by_stage.get(stage, {})}; {shown}")
    say(f"[full] run_full: {wall:.1f} s wall with stage_workers="
        f"{cfg.stage_workers}; launches {total}")
    say(f"[full] sort launches by key count {sizes}: "
        f"{below(sizes, SMALL_SORT_KEYS)} of {total['radix_sort']} under "
        f"2**17 keys")

    check(total["banded_general"] > 0, "run_full never launched the "
          "general banded kernel")
    general_stages = {s for s, c in by_stage.items() if "banded_general" in c}
    check(general_stages == {"patch_gaps"}, f"general kernel launched in "
          f"{general_stages}, expected patch_gaps only")
    for stage in ("align_frags", "align_jumps"):
        check(by_stage.get(stage, {}).get("banded_bp", 0) > 0,
              f"{stage} never launched the bit-parallel kernel")
    m = {s: rd.metrics(s) for s in FULL_STAGES}
    pileup_stages = {s for s, c in by_stage.items() if "pileup" in c}
    check(pileup_stages == {"polish"}, f"pileup kernel launched in "
          f"{pileup_stages}, expected polish only")
    passes = 2 + (m["polish"]["n_indels_fixed"] > 0)   # one segment each
    check(total["pileup"] == passes, f"polish launched the pileup kernel "
          f"{total['pileup']} times in {passes} passes")
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
    if not keep:
        shutil.rmtree(run_dir, ignore_errors=True)
    return total, sizes


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


CMP_DIR = ROOT / "build" / "chip_smoke_cmp"      # phase 9b's run dirs
ASSIST_REF = ROOT / "build" / "chip_smoke_relative.fasta"
LONG_OVERRIDES = dict(batch_reads=16384, assist_ref=str(ASSIST_REF))


def long_compare_run(device: str) -> tuple:
    """One of phase 9b's runs: run_full through the port on `device` over
    long_cmp_inputs (save_inputs) with an assisting reference, in
    CMP_DIR / device: (run dir, launches by stage, wall s)."""
    from allpathslg_tpu_torch import trace
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.stages import Pipeline

    inputs, g = long_cmp_inputs()
    ASSIST_REF.parent.mkdir(parents=True, exist_ok=True)
    write_assist_ref(ASSIST_REF, g)
    run_dir = CMP_DIR / device
    shutil.rmtree(run_dir, ignore_errors=True)
    rd = RunDir(str(run_dir))
    save_inputs(rd, inputs)
    pipe = Pipeline(rd, AssemblyConfig.from_overrides(**LONG_OVERRIDES),
                    lambda *a: None, device=device)
    trace.reset()
    t0 = time.perf_counter()
    pipe.run_full()
    if device == "cuda":
        torch.cuda.synchronize()
    return rd, trace.by_stage(), time.perf_counter() - t0


def phase_long_compare(cpu_wall: float):
    """Phase 9b: run_full on the card over long_cmp_inputs (long_compare_run)
    against the CPU's run of cpu_runs, made before: long_read_patch must
    launch the general kernel and close a gap on the card, and every
    artifact of LONG_ARTIFACTS, every file of CMP_TEXT_FILES and every
    stage metric of LONG_STAGES must be the same, byte for byte. Returns
    the card run's launches by stage."""
    from allpathslg_tpu_torch.pipeline.rundir import RunDir

    tag = "compare-long"
    check((CMP_DIR / "cpu").is_dir(), f"[{tag}] no CPU run in {CMP_DIR}")
    gpu, card, wall = long_compare_run("cuda")
    cpu = RunDir(str(CMP_DIR / "cpu"))
    say(f"[{tag}] run_full on cuda: {wall:.1f} s; launches by stage {card}")
    say(f"[{tag}] run_full on cpu: {cpu_wall:.1f} s (cpu_runs' child "
        f"process, while phase 8 ran)")
    check(card.get("long_read_patch", {}).get("banded_general", 0) > 0,
          f"[{tag}] run_full on the card never launched banded_general in "
          f"long_read_patch")
    for art in LONG_ARTIFACTS:
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
    for stage in LONG_STAGES:
        check(gpu.metrics(stage) == cpu.metrics(stage),
              f"{stage} metrics differ: card {gpu.metrics(stage)}, CPU "
              f"{cpu.metrics(stage)}")
    closed = {s: gpu.metrics(s)["n_gaps_closed"] for s in LONG_STAGES
              if "n_gaps_closed" in gpu.metrics(s)}
    check(closed.get("long_read_patch", 0) >= 1,
          f"[{tag}] long_read_patch closed no gap")
    say(f"[{tag}] card == CPU: {len(LONG_ARTIFACTS)} artifacts, "
        f"{len(CMP_TEXT_FILES)} files and {len(LONG_STAGES)} stages' metrics "
        f"byte-identical; gaps closed {closed}")
    shutil.rmtree(CMP_DIR, ignore_errors=True)
    ASSIST_REF.unlink()
    return card


# Phase 9's N bases, drawn from the seed: a share of all bases, and a share
# of reads that end in a run of N of a length in N_TAIL_LEN
N_BASE_RATE, N_TAIL_READS, N_TAIL_LEN = 0.001, 0.01, (5, 10)
# What phase 9 may find different between the card and the CPU on
# N-bearing reads, and only when the bit-parallel kernel's query-N split
# (ROADMAP Queue 3) shows in its captured calls: none so far
CLI_N_SPLIT_MAY_DIFFER = ()


def with_n_bases(lib: dict, rng) -> dict:
    """A copy of a read library {codes, lengths, ...} with N_BASE_RATE of
    its bases set to N and N_TAIL_READS of its reads ending in an N run."""
    codes = np.array(lib["codes"])
    lengths = np.asarray(lib["lengths"])
    col = np.arange(codes.shape[1])[None, :]
    inside = col < lengths[:, None]
    codes[(rng.random(codes.shape) < N_BASE_RATE) & inside] = 4
    tail = rng.random(len(codes)) < N_TAIL_READS
    run = rng.integers(N_TAIL_LEN[0], N_TAIL_LEN[1] + 1, len(codes))
    codes[tail[:, None] & inside & (col >= (lengths - run)[:, None])] = 4
    return {**lib, "codes": codes}


def _log_lines(d: Path, marks=("[check]", "] CHEAT:")) -> list:
    """pipeline.log's lines that hold one of `marks`, without the stamp."""
    lines = (d / "pipeline.log").read_text().splitlines()
    return [ln[20:] for ln in lines if any(m in ln for m in marks)]


def run_dir_diff(a: Path, b: Path) -> list:
    """What differs between two run dirs: files (arrays key by key),
    stage metrics and the check and CHEAT log lines."""
    from allpathslg_tpu_torch.pipeline.rundir import RunDir

    skip = ("pipeline.log", "manifest.json")
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*")
                   if p.is_file() and p.name not in skip)
    other = sorted(str(p.relative_to(b)) for p in b.rglob("*")
                   if p.is_file() and p.name not in skip)
    diff = sorted(set(names) ^ set(other))
    rd_a, rd_b = RunDir(str(a)), RunDir(str(b))
    for name in sorted(set(names) & set(other)):
        if name.endswith(".npz"):
            x, y = rd_a.load_arrays(name[:-4]), rd_b.load_arrays(name[:-4])
            diff += [f"{name}[{k}]" for k in sorted(set(x) | set(y))
                     if k not in x or k not in y or x[k].dtype != y[k].dtype
                     or x[k].shape != y[k].shape
                     or x[k].tobytes() != y[k].tobytes()]
        elif (a / name).read_bytes() != (b / name).read_bytes():
            diff.append(name)
    sa, sb = rd_a.manifest["stages"], rd_b.manifest["stages"]
    diff += [f"metrics:{st}" for st in sorted(set(sa) | set(sb))
             if sa.get(st, {}).get("metrics") != sb.get(st, {}).get("metrics")]
    if _log_lines(a) != _log_lines(b):
        diff.append("pipeline.log: check/CHEAT lines")
    return diff


def query_n_split(capture: DPCapture) -> dict:
    """Every captured bit-parallel call of phase 9's card run held against
    its plain version (a query code >= 4 matches nothing, as in the
    kernel), exactly; and counted against ops/banded.banded_align on the
    same inputs, the CPU pipeline's route, where a query N matches a
    target pad 4: the calls and rows where that split changes the
    result."""
    from allpathslg_tpu_torch.ops import banded
    from allpathslg_tpu_torch.ops.cuda import banded_cuda

    out = {"calls": 0, "rows": 0, "split_calls": 0, "split_rows": 0,
           "stages": set()}
    for key, kept in capture.kept.items():
        if key[0] != "banded_bp":
            continue
        for arrays, kw, (cost, t_end) in kept:
            want = banded_cuda.banded_align_bp_plain(*arrays, **kw)
            check(torch.equal(cost, want[0]) and torch.equal(t_end, want[1]),
                  f"[cli] bit-parallel kernel != plain version on a {key[1]} "
                  f"call")
            cpu_c, cpu_e = banded.banded_align(*arrays, **kw)
            split = (cost != cpu_c) | (t_end != cpu_e)
            n = int(split.sum())
            out["calls"] += 1
            out["rows"] += cost.shape[0]
            if n:
                out["split_calls"] += 1
                out["split_rows"] += n
                out["stages"].add(key[1])
    return out


CLI_DIR = ROOT / "build" / "chip_smoke_cli"   # phase 9's files, run dirs


def cli_inputs(seed: int) -> tuple:
    """Phase 9's inputs: (cmp_inputs(), its two read libraries with N
    bases drawn from the seed)."""
    inputs = cmp_inputs()
    rng = np.random.default_rng(seed + 9)
    libs = {k: with_n_bases({key: np.asarray(v) for key, v in
                             inputs[k].items()}, rng)
            for k in ("frag_reads_orig", "jump_reads_orig")}
    return inputs, libs


def cli_run(seed: int, device: str, capture=None) -> float:
    """One of phase 9's runs: pipeline.run.main on `device` from the sheets
    in CLI_DIR / "reads" into CLI_DIR / device, with `capture` installed
    when given; the CPU's run, made first, writes the files. Returns the
    run's wall s."""
    from allpathslg_tpu_torch.pipeline import run as prun
    from allpathslg_tpu_torch.pipeline.rundir import RunDir

    inputs, libs = cli_inputs(seed)
    files = CLI_DIR / "reads"
    if device == "cpu":
        shutil.rmtree(CLI_DIR, ignore_errors=True)
        write_read_files(files, libs["frag_reads_orig"],
                         libs["jump_reads_orig"], (FRAG_INSERT, FRAG_SD),
                         (4000, 350))
    d = CLI_DIR / device
    shutil.rmtree(d, ignore_errors=True)
    RunDir(str(d)).save_arrays("genome_truth",
                               genome=inputs["genome_truth"]["genome"])
    if capture is not None:
        capture.install()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = prun.main(["--run-dir", str(d), "--device", device,
                            "--in-libs", str(files / "in_libs.csv"),
                            "--in-groups", str(files / "in_groups.csv"),
                            "check_mode=true", "evaluation=CHEAT",
                            "batch_reads=4096"])
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        if capture is not None:
            capture.remove()
    check(rc == 0, f"[cli] pipeline.run.main on {device} returned {rc}")
    return time.perf_counter() - t0


def phase_cli_compare(seed: int, cpu_wall: float):
    """Phase 9: tests/test_torch_full.py's 40 kb inputs with N bases
    (with_n_bases) written as files, then pipeline.run.main from the
    sheets with check_mode and evaluation=CHEAT on the card (cli_run),
    against the CPU's run of cpu_runs, made before; every file, array,
    stage metric and check/CHEAT log line compared. Returns the card
    run's launches by stage."""
    from allpathslg_tpu_torch import trace
    from allpathslg_tpu_torch.pipeline.rundir import RunDir

    base = CLI_DIR
    check((base / "cpu").is_dir() and (base / "reads").is_dir(),
          f"[cli] no CPU run in {base}")
    _, libs = cli_inputs(seed)
    n_bases = {k: int((v["codes"] == 4).sum()
                      - (v["codes"].shape[1] - v["lengths"]).sum())
               for k, v in libs.items()}
    capture = DPCapture()
    capture.KEEP = 1 << 30            # every call
    trace.reset()
    wall = cli_run(seed, "cuda", capture)
    card = trace.by_stage()
    say(f"[cli] inputs: {n_bases} N bases within reads ({N_BASE_RATE} of "
        f"bases, {N_TAIL_READS} of reads ending in 5-10 N); run_full from "
        f"sheets through pipeline.run.main with check_mode and CHEAT: card "
        f"{wall:.1f} s, CPU {cpu_wall:.1f} s (cpu_runs' child process, "
        f"while phase 8 ran); card launches by stage {card}")
    check(card.get("validate_inputs", {}).get("radix_sort", 0) > 0,
          "[cli] check_mode's spectrum never launched the sort kernel")
    check(card.get("patch_gaps", {}).get("banded_general", 0) > 0,
          "[cli] patch_gaps never launched the general kernel")
    for device in ("cuda", "cpu"):
        lines = _log_lines(base / device)
        check("  [check] spectrum oracle ok on 512 reads" in lines,
              f"[cli] no check_mode line in the {device} run's log")
        check(sum("] CHEAT:" in ln for ln in lines) == 2,
              f"[cli] the {device} run logged no CHEAT metrics")
    split = query_n_split(capture)
    diff = run_dir_diff(base / "cuda", base / "cpu")
    say(f"[cli] bit-parallel calls on the card {split['calls']} "
        f"({split['rows']} rows), each == its plain version; where a query "
        f"N meets a target pad the CPU route differs in "
        f"{split['split_calls']} calls ({split['split_rows']} rows; stages "
        f"{sorted(split['stages'])})")
    unexplained = [x for x in diff if x not in CLI_N_SPLIT_MAY_DIFFER]
    check(not unexplained, f"[cli] the card's run differs from the CPU's "
          f"in {unexplained}")
    check(not diff or split["split_rows"] > 0,
          f"[cli] {diff} differ with no query-N split in the DP calls")
    fe = RunDir(str(base / "cuda")).metrics("find_errors")
    un = RunDir(str(base / "cuda")).metrics("unipaths")
    n_files = sum(1 for p in (base / "cuda").rglob("*") if p.is_file())
    say(f"[cli] card == CPU: {n_files} files (arrays key by key), every "
        f"stage metric and the check/CHEAT log lines"
        f"{' except ' + str(diff) if diff else ''}; CHEAT: true-kmer frac "
        f"{fe['cheat_true_kmer_frac_before']} -> "
        f"{fe['cheat_true_kmer_frac_after']}, unipaths covered "
        f"{un['cheat_genome_covered_frac']}")
    shutil.rmtree(base, ignore_errors=True)
    return card


# Phases 9 and 9b hold the card's run against the CPU's. The CPU's runs
# need no card, so a child process that sees none makes them (cpu_runs)
# while phase 8 holds the card and a few of the host's cores; phases 9
# and 9b wait for it, then make the card's runs and compare
CPU_RUNS_CHILD = r"""
import json, sys
import chip_smoke as smoke
print("cpu_runs", json.dumps(smoke.cpu_runs(int(sys.argv[1]), sys.argv[2:])),
      flush=True)
"""
CPU_RUNS_LOG = ROOT / "build" / "chip_smoke_cpu_runs.log"
CPU_RUNS_TIMEOUT_S = 900


def cpu_runs(seed: int, phases) -> dict:
    """The CPU's runs of those of phases 9 and 9b in `phases`: {phase:
    wall s}."""
    walls = {}
    if "9" in phases:
        walls["9"] = cli_run(seed, "cpu")
    if "9b" in phases:
        walls["9b"] = long_compare_run("cpu")[2]
    return walls


def start_cpu_runs(seed: int, phases) -> subprocess.Popen:
    """cpu_runs in a child process that sees no card, its output in
    CPU_RUNS_LOG; killed at exit if it still runs."""
    CPU_RUNS_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(CPU_RUNS_LOG, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", CPU_RUNS_CHILD, str(seed), *phases],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def cpu_runs_result(proc: subprocess.Popen) -> dict:
    """Waits for start_cpu_runs' child: {phase: CPU wall s}."""
    try:
        rc = proc.wait(timeout=CPU_RUNS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = f"killed after {CPU_RUNS_TIMEOUT_S} s"
    text = CPU_RUNS_LOG.read_text()
    check(rc == 0, f"the CPU runs' child failed ({rc}):\n{text[-3000:]}")
    line = [ln for ln in text.splitlines() if ln.startswith("cpu_runs ")][-1]
    return json.loads(line[len("cpu_runs "):])


# Phase 11: the tools CLI's inputs (bench.py's lookup cell for align;
# tests/test_longproto.py's read shape for longproto, its region scaled up)
ALIGN_GENOME, ALIGN_CONTIGS, ALIGN_READS = 2_000_000, 16, 65_536
LONGPROTO_REGION, LONGPROTO_COVERAGE = 100_000, 50.0


def _tool(argv) -> tuple:
    """(stdout, seconds) of tools.main(argv)."""
    from allpathslg_tpu_torch import tools

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tools.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"tools {argv[0]} returned {rc}")
    return buf.getvalue(), time.perf_counter() - t0


class LaunchStages:
    """Counts the kernel launches made inside calls to module attributes
    under a stage of their own (allpathslg_tpu_torch/trace.stage)."""

    def __init__(self, targets):
        self.targets = targets          # [(module name, attribute, stage)]
        self._saved = []

    def __enter__(self):
        import importlib

        from allpathslg_tpu_torch import trace

        for module, attr, stage in self.targets:
            mod = importlib.import_module(f"allpathslg_tpu_torch.{module}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _stage=stage, **kw):
                with trace.stage(_stage):
                    return _fn(*a, **kw)

            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def phase_tools(codes: np.ndarray, spectrum: torch.Tensor, seed: int):
    """Phase 11: the tools CLI on the card. kspec on the flagship batch as
    FASTQ (its spectrum == phase 4's), align at bench.py's lookup shape
    (>= 90 % of the reads that lie inside one contig placed at their true
    contig, position and strand; the bit-parallel kernel launched in the
    rescue), longproto on a LONGPROTO_REGION region (the longest contig
    covers >= 90 % of it; the sort kernel launched in friend finding and
    in counting). Returns the launches of each kernel."""
    from allpathslg_tpu_torch.eval import sim
    from allpathslg_tpu_torch.io import fasta
    from allpathslg_tpu_torch.kmer import spectrum as kspec
    from allpathslg_tpu_torch.models import flagship
    from allpathslg_tpu_torch import trace

    d = ROOT / "build" / "chip_smoke_tools"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    total = {}

    def count(tag):
        by = trace.by_stage()
        for kernels in by.values():
            for k, n in kernels.items():
                total[k] = total.get(k, 0) + n
        say(f"[tools] {tag} launches by stage {by}")
        return by

    # kspec
    write_fastq(d / "flagship.fastq", codes, np.full_like(codes, 40), b"k")
    got = []
    orig = flagship.spectrum_step

    def keep(*a, **kw):
        out = orig(*a, **kw)
        got.append(out[0].cpu())
        return out

    trace.reset()
    flagship.spectrum_step = keep
    try:
        out, secs = _tool(["kspec", str(d / "flagship.fastq"), "--k",
                           str(FLAGSHIP_K)])
    finally:
        flagship.spectrum_step = orig
    by = count("kspec")
    check(len(got) == 1 and torch.equal(got[0], spectrum),
          "tools kspec's spectrum != phase 4's")
    ana = kspec.analyze(spectrum.numpy())
    res = json.loads(out)
    check(res["n_distinct"] == ana.n_distinct
          and res["genome_size_est"] == ana.genome_size_est,
          f"tools kspec printed {res}, phase 4's spectrum gives {ana}")
    check(by.get(None, {}).get("radix_sort", 0) > 0,
          "tools kspec never launched the sort kernel")
    say(f"[tools] kspec: {secs:.1f} s on {codes.shape[0]} x {codes.shape[1]} "
        f"reads at K={FLAGSHIP_K}: spectrum == phase 4's; {out.strip()}")

    # align
    genome = sim.random_genome(ALIGN_GENOME, seed=5)
    cl = ALIGN_GENOME // ALIGN_CONTIGS
    fasta.write_fasta(str(d / "contigs.fasta"),
                      [(f"contig_{i}", genome[i * cl:(i + 1) * cl])
                       for i in range(ALIGN_CONTIGS)])
    rb, _, truth = sim.simulate_paired_reads(genome, coverage=3.3,
                                             error_rate=0.01, seed=6)
    n = ALIGN_READS
    rcodes = np.asarray(rb.codes)[:n]
    write_fastq(d / "reads.fastq", rcodes, np.asarray(rb.quals)[:n], b"r")
    trace.reset()
    out, secs = _tool(["align", str(d / "reads.fastq"),
                       str(d / "contigs.fasta")])
    by = count("align")
    rows = [ln.split("\t") for ln in out.splitlines()]
    check(len(rows) == n, f"tools align printed {len(rows)} rows for {n}")
    start = truth.read_starts[:n].astype(np.int64)
    rc = truth.read_rc[:n]
    L = rcodes.shape[1]
    contig = start // cl
    inside = start + L <= (contig + 1) * cl
    want_pos = start - contig * cl + np.where(rc, L - 1, 0)
    placed = np.array([r[5] == "1" and r[1] == f"contig_{c}"
                       and int(r[2]) == p and r[3] == ("-" if o else "+")
                       for r, c, p, o in zip(rows, contig, want_pos, rc)])
    rate = float(placed[inside].mean())
    aligned = float(np.mean([r[5] == "1" for r in rows]))
    check(rate >= 0.90, f"tools align placed {rate} of the reads at their "
          f"true place (< 0.90)")
    check(by.get(None, {}).get("banded_bp", 0) > 0,
          "tools align never launched the bit-parallel kernel")
    say(f"[tools] align: {secs:.1f} s for {n} reads on {ALIGN_GENOME} bp in "
        f"{ALIGN_CONTIGS} contigs; aligned {aligned:.4f}; of the "
        f"{int(inside.sum())} reads inside one contig, {rate:.4f} at their "
        f"true contig, position and strand")

    # longproto
    region = sim.random_genome(LONGPROTO_REGION, seed=seed + 81)
    lb, _, _ = sim.simulate_paired_reads(
        region, coverage=LONGPROTO_COVERAGE, read_len=250, insert_mean=450,
        insert_sd=20, error_rate=0.004, seed=seed + 82)
    write_fastq(d / "long.fastq", np.asarray(lb.codes), np.asarray(lb.quals),
                b"l")
    trace.reset()
    with LaunchStages((("long.friends", "find_friends", "friends"),
                       ("kmer.count", "count_reads_streaming", "count"))):
        out, secs = _tool(["longproto", str(d / "long.fastq"), "--out",
                           str(d / "longproto.fasta")])
    by = count("longproto")
    res = json.loads(out)
    best = max((len(s) for _, s in fasta.read_fasta(
        str(d / "longproto.fasta"))), default=0)
    for stage in ("friends", "count"):
        check(by.get(stage, {}).get("radix_sort", 0) > 0,
              f"tools longproto never launched the sort kernel in {stage}")
    check(best >= 0.9 * LONGPROTO_REGION, f"tools longproto's longest "
          f"contig {best} < 0.9 x {LONGPROTO_REGION}")
    say(f"[tools] longproto: {secs:.1f} s for {lb.n_reads} reads of 250 bp "
        f"({LONGPROTO_COVERAGE:g}x of {LONGPROTO_REGION} bp); longest "
        f"contig {best}; {res}")
    shutil.rmtree(d, ignore_errors=True)
    return total


class StageTimer:
    """Host wall time of calls to module attributes, by the pipeline stage
    of the calling thread: {(stage, "module.attr"): [seconds, calls]}.
    Each call ends with torch.cuda.synchronize(), so a function that
    returns device tensors is timed with its kernels."""

    def __init__(self, targets):
        import threading

        self.targets = targets          # [(module name, attribute)]
        self.totals = {}
        self._lock = threading.Lock()
        self._saved = []

    def install(self):
        import importlib

        from allpathslg_tpu_torch import trace

        for module, attr in self.targets:
            mod = importlib.import_module(f"allpathslg_tpu_torch.{module}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _name=f"{module}.{attr}", **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    key = (trace.current_stage(), _name)
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
DIPLOID_TIMED_GENERAL = 2


def phase_diploid(genome_size: int, capture: DPCapture):
    """Phase 10: run_full on the card over diploid_inputs of a repeat
    genome (REPEAT_FAMILIES) with an assisting reference, ploidy=2, with
    `capture` installed; returns each kernel's launches in the run."""
    from allpathslg_tpu_torch.eval import accuracy as eacc
    from allpathslg_tpu_torch import trace
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
    trace.reset()
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
    by_stage = trace.by_stage()
    total = {k: trace.count(k) for k in ("radix_sort", "banded_bp",
                                             "banded_general", "pileup")}
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


# ---- phase 12: the library modules (ops/affine, align/mxu_scan,
# graph/ulinks with native/radix_sort.cpp, long/ultra) ----
AFFINE_SHAPE = (16_384, 100, 140, 16)   # bench.py's DP shape (B, Lq, Lt), band
AFFINE_ORACLE_ROWS = 64
MXU_TARGET, MXU_READS, MXU_LEN = 1_000_000, 1024, 100
MXU_LONG = (200_000, 256, 300)          # target, reads, L: counts pass 256
MXU_COUNTED = 64
ULINKS_K, ULINKS_TILE, ULINKS_STEP = 24, 100, 10
ULINKS_COVERAGE, ULINKS_INSERT, ULINKS_SD = 40.0, 3000, 300
ULINKS_GENOME, ULINKS_CMP_GENOME = 1_000_000, 200_000
ULINKS_MAX_SEP = 10_000
ULTRA_CMP_GENOME, ULTRA_CRITERION_GENOME = 20_000, 60_000
# the reference's tests/test_ultra.py criterion
ULTRA_MIN_CLEAN, ULTRA_TOTAL, ULTRA_MIN_COVERED = 0.70, (0.7, 1.5), 0.80
ULTRA_TIMED = (("long.ultra", "friend_hits"), ("long.ultra", "_select_hits"),
               ("long.ultra", "_build_problems"),
               ("long.ultra", "_votes_forward"),
               ("long.ultra", "_votes_traceback"),
               ("long.ultra", "_consensus"))


# idle seconds inside the profiler's window on either side of the
# profiled call: late in a whole smoke, without them, the profiler
# recorded no kernel of a 0.1 s call and lost some of a longer one's;
# with them it recorded all, but for a rare profile that records no
# kernel at all (one of the calls after affine's in a whole smoke), which
# a second profile of the same call does not repeat
PROFILE_MARGIN_S = 0.5
PROFILE_ATTEMPTS = 3


def kernel_rows(fn, what: str):
    """(fn(), kernel launches, their summed device ms): fn() run under
    torch.profiler recording the card's activity only, PROFILE_MARGIN_S
    idle on either side, its kernel rows (device_type CUDA, copies and
    sets left out); run and profiled again when a profile recorded no
    kernel. Raises when none of PROFILE_ATTEMPTS profiles recorded one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            out = fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset"))]
        n = sum(e.count for e in rows)
        if n > 0:
            break
        say(f"[profile] {what}: torch.profiler recorded no kernel in "
            f"profile {attempt} of {PROFILE_ATTEMPTS}")
    check(n > 0, f"{what}: torch.profiler recorded no kernel")
    return out, n, sum(e.self_device_time_total for e in rows) / 1e3


def peak_mib(fn):
    """(fn(), the peak device memory it allocated, MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def lib_affine(seed: int):
    """(a) ops/affine at bench.py's DP shape, band 16 (dp_problems: ragged
    lengths, offsets with no in-band path): the card == the CPU (cost and
    t_end), the numpy oracle on AFFINE_ORACLE_ROWS rows."""
    from allpathslg_tpu_torch.ops import affine

    B, Lq, Lt, band = AFFINE_SHAPE
    arrays = dp_problems(np.random.default_rng(seed + 120), B, Lq, Lt, band)
    cpu = [torch.from_numpy(a) for a in arrays]
    card = [a.to("cuda") for a in cpu]

    def run():
        return affine.affine_banded_align(*card, band=band)

    (cost, t_end), n_kern, dev_ms = kernel_rows(run, "affine")
    t0 = time.perf_counter()
    want = affine.affine_banded_align(*cpu, band=band)
    cpu_s = time.perf_counter() - t0
    check(torch.equal(cost.cpu(), want[0]) and torch.equal(t_end.cpu(),
                                                           want[1]),
          "affine: the card's cost / t_end != the CPU's")
    no_path = np.nonzero(want[0].numpy() == affine.BIG)[0]
    check(len(no_path) > 0 and (want[1].numpy()[no_path] == -1).all(),
          "affine: no row without an in-band path, or its t_end != -1")
    q, ql, t, tl, off = arrays
    rows = np.concatenate([no_path[:8], np.arange(AFFINE_ORACLE_ROWS - 8)])
    for r in rows:
        oc, _ = affine.np_affine_oracle(q[r, :ql[r]], t[r, :tl[r]],
                                        int(off[r]), band)
        check(int(want[0][r]) == oc, f"affine: row {r} cost "
              f"{int(want[0][r])} != the oracle's {oc}")
    wall = median_ms(run)
    say(f"[lib] affine {B} x {Lq} x {Lt} band {band}: card == CPU "
        f"(cost, t_end), {len(no_path)} rows without an in-band path, "
        f"oracle == on {len(rows)} rows; card {wall:.3f} ms a call "
        f"(median_ms), {n_kern} kernel launches, {dev_ms:.3f} ms of "
        f"them on the device (torch.profiler); CPU {cpu_s:.2f} s")


def planted_reads(rng, target: np.ndarray, n: int, L: int):
    """n reads of L bp planted on `target` with 0-3 substitutions, half
    reverse-complemented, lengths ragged within the last fifth (pad 4):
    (reads, lengths, starts, is_rc, n_subs)."""
    reads = np.full((n, L), 4, np.uint8)
    lengths = rng.integers(L - L // 5, L + 1, n).astype(np.int32)
    lengths[: n // 8] = L
    starts = rng.integers(0, len(target) - L, n)
    is_rc = rng.random(n) < 0.5
    n_subs = rng.integers(0, 4, n)
    for i in range(n):
        seg = target[starts[i]:starts[i] + lengths[i]].copy()
        pp = rng.choice(len(seg), n_subs[i], replace=False)
        seg[pp] = (seg[pp] + rng.integers(1, 4, len(pp))) % 4
        reads[i, :lengths[i]] = (3 - seg[::-1]) if is_rc[i] else seg
    return reads, lengths, starts, is_rc, n_subs


def lib_mxu(seed: int):
    """(b) align/mxu_scan: MXU_READS reads of MXU_LEN bp on a MXU_TARGET
    bp target, each placed at its planted offset and strand with its
    substitutions counted; match_counts == an integer count on
    MXU_COUNTED reads; at MXU_LONG (counts above 256) the card == the
    CPU for both lookups."""
    from allpathslg_tpu_torch.align import mxu_scan
    from allpathslg_tpu_torch.eval import sim

    rng = np.random.default_rng(seed + 121)
    target = sim.random_genome(MXU_TARGET, seed=seed + 122)
    reads, lengths, starts, is_rc, n_subs = planted_reads(
        rng, target, MXU_READS, MXU_LEN)
    tc, rc_, lc = (torch.from_numpy(a).to("cuda")
                   for a in (target, reads, lengths))
    (pos, urc, mism), n_kern, dev_ms = kernel_rows(
        lambda: mxu_scan.imperfect_lookup(tc, rc_, lc), "mxu_scan")
    check(np.array_equal(pos.cpu().numpy(), starts)
          and np.array_equal(urc.cpu().numpy(), is_rc)
          and np.array_equal(mism.cpu().numpy(), n_subs),
          "mxu_scan: imperfect_lookup missed a planted read")
    ppos, prc, nh = (x.cpu().numpy()
                     for x in mxu_scan.perfect_lookup(tc, rc_, lc))
    exact = n_subs == 0
    check(np.array_equal(nh, exact.astype(np.int32))
          and np.array_equal(ppos[exact, 0], starts[exact])
          and np.array_equal(prc[exact, 0], is_rc[exact])
          and (ppos[:, 1:] == -1).all(),
          "mxu_scan: perfect_lookup's hits != the planted exact reads")
    mc = mxu_scan.match_counts(tc, rc_[:MXU_COUNTED])
    win = tc.unfold(0, MXU_LEN, 1)
    for i in range(MXU_COUNTED):
        r = rc_[i]
        want = ((win == r) & (r < 4)).sum(dim=1, dtype=torch.int32)
        check(torch.equal(mc[i], want),
              f"mxu_scan: match_counts of read {i} != the integer count")
    del mc, win
    ms = {name: median_ms(lambda f=f: f(tc, rc_, lc), reps=5)
          for name, f in (("imperfect_lookup", mxu_scan.imperfect_lookup),
                          ("perfect_lookup", mxu_scan.perfect_lookup))}
    ms["match_counts"] = median_ms(lambda: mxu_scan.match_counts(tc, rc_),
                                   reps=5)
    mib = {name: peak_mib(lambda f=f: f(tc, rc_, lc))[1]
           for name, f in (("imperfect_lookup", mxu_scan.imperfect_lookup),
                           ("perfect_lookup", mxu_scan.perfect_lookup))}
    say(f"[lib] mxu_scan {MXU_READS} reads of {MXU_LEN} bp (0-3 "
        f"substitutions, both strands, ragged) on {MXU_TARGET} bp: every "
        f"read at its planted place, {int(exact.sum())} exact reads each "
        f"one perfect hit; match_counts == integer count on {MXU_COUNTED} "
        f"reads; ms (median_ms) {show_terms(ms)}; peak MiB "
        f"{show_terms(mib)}; imperfect_lookup {n_kern} kernel launches, "
        f"{dev_ms:.3f} ms of them on the device")
    del tc, rc_, lc
    G, n, L = MXU_LONG
    target = sim.random_genome(G, seed=seed + 123)
    reads, lengths, *_ = planted_reads(rng, target, n, L)
    cpu = [torch.from_numpy(a) for a in (target, reads, lengths)]
    card = [a.to("cuda") for a in cpu]
    mc = mxu_scan.match_counts(*card[:2])
    win = card[0].unfold(0, L, 1)
    for i in range(n):
        r = card[1][i]
        check(torch.equal(mc[i], ((win == r) & (r < 4)).sum(
            dim=1, dtype=torch.int32)),
              f"mxu_scan: match_counts at L = {L}, read {i} != the integer "
              f"count")
    top = int(mc.max())
    check(top == L, f"mxu_scan: the best count at L = {L} is {top}")
    for fn in (mxu_scan.imperfect_lookup, mxu_scan.perfect_lookup):
        for g, w in zip(fn(*card), fn(*cpu)):
            check(torch.equal(g.cpu(), w),
                  f"mxu_scan: {fn.__name__} at L = {L}: card != CPU")
    say(f"[lib] mxu_scan {n} reads of {L} bp on {G} bp: counts up to "
        f"{top}, {int((mc > 256).sum())} above 256; match_counts == the "
        f"integer count; imperfect_lookup and perfect_lookup: card == CPU")


def ulinks_chain(genome: np.ndarray, device: str, seed: int):
    """Unipaths from error-free tiles of `genome` (count, build_unipaths),
    read paths of ULINKS_COVERAGE x jump pairs of ULINKS_INSERT +-
    ULINKS_SD, the link graph and the neighbourhoods of the CN=1 seeds,
    on `device`: (unipaths, read paths, link graph, seeds,
    neighbourhoods, {step: s}, link keys sorted)."""
    from allpathslg_tpu_torch.eval import sim
    from allpathslg_tpu_torch.graph import coverage, pathsdb, ulinks, unipath
    from allpathslg_tpu_torch.kmer import count

    secs = {}
    t = [time.perf_counter()]

    def lap(step):
        if device != "cpu":
            torch.cuda.synchronize()
        now = time.perf_counter()
        secs[step] = now - t[0]
        t[0] = now

    starts = np.arange(0, len(genome) - ULINKS_TILE + 1, ULINKS_STEP)
    tiles = genome[starts[:, None] + np.arange(ULINKS_TILE)]
    ck = count.trim_to_host(count.count_reads(
        torch.from_numpy(tiles).to(device), ULINKS_K))
    lap("count")
    ups, _, pl = unipath.build_unipaths(
        ck.words, ULINKS_K, min_count=1, counts=ck.counts, with_graph=True,
        with_placement=True, device=device)
    lap("build_unipaths")
    jb, pairs, _ = sim.simulate_paired_reads(
        genome, coverage=ULINKS_COVERAGE, read_len=100,
        insert_mean=ULINKS_INSERT, insert_sd=ULINKS_SD, error_rate=0.0,
        seed=seed)
    t[0] = time.perf_counter()
    rp = pathsdb.path_reads(pl, np.asarray(jb.codes))
    lap("path_reads")
    keys = []
    orig = ulinks.sort_u64_with_payload

    def counted(k, p):
        keys.append(len(k))
        return orig(k, p)

    ulinks.sort_u64_with_payload = counted
    try:
        lg = ulinks.build_ulink_graph(rp, np.asarray(pairs.pairs),
                                      ups.kmer_counts, ULINKS_K,
                                      ULINKS_INSERT, ULINKS_SD)
    finally:
        ulinks.sort_u64_with_payload = orig
    lap("build_ulink_graph")
    cn, _ = coverage.copy_numbers(ups)
    seeds = coverage.select_seeds(ups, cn)
    nh = ulinks.neighborhoods(lg, seeds, max_sep=ULINKS_MAX_SEP)
    lap("neighborhoods")
    return ups, rp, lg, seeds, nh, secs, sum(keys)


def lib_ulinks(seed: int) -> int:
    """(c) graph/ulinks on repeat_genome(ULINKS_GENOME) on the card: at
    least 2**14 link keys through the native radix sort, links of >= 2
    pairs, every CN=1 seed in its own neighbourhood; at ULINKS_CMP_GENOME
    the card == the CPU byte for byte. Returns the sort kernel's
    launches."""
    from allpathslg_tpu_torch.native import build as native_build
    from allpathslg_tpu_torch import trace

    trace.reset()
    ups, rp, lg, seeds, nh, secs, n_keys = ulinks_chain(
        repeat_genome(ULINKS_GENOME, seed + 124), "cuda", seed + 125)
    n_sort = trace.count("radix_sort")
    check(n_sort > 0, "ulinks: the sort kernel never launched")
    check(n_keys >= native_build.NATIVE_SORT_MIN, f"ulinks: {n_keys} link "
          f"keys < {native_build.NATIVE_SORT_MIN}: the native sort never ran")
    check(lg.n_edges > 0 and (lg.n_pairs >= 2).all() and (lg.a != lg.b).all(),
          f"ulinks: {lg.n_edges} links, or one of < 2 pairs or a self link")
    check(len(seeds) > 0 and all(s in h for s, h in zip(seeds, nh))
          and max(len(h) for h in nh) >= 2,
          "ulinks: a seed outside its neighbourhood, or none linked")
    say(f"[lib] ulinks {ULINKS_GENOME} bp repeat genome: {ups.n} unipaths, "
        f"{rp.n_reads} jump reads pathed, {n_keys} link keys through the "
        f"native sort, {lg.n_edges} links, {len(seeds)} CN=1 seeds, "
        f"neighbourhood sizes {min(len(h) for h in nh)}-"
        f"{max(len(h) for h in nh)}; s {show_terms(secs)}; sort kernel "
        f"launches {n_sort}")
    g = repeat_genome(ULINKS_CMP_GENOME, seed + 126)
    got = ulinks_chain(g, "cuda", seed + 127)
    want = ulinks_chain(g, "cpu", seed + 127)
    for name, fields, x, y in (
            ("unipaths", ("bases", "offsets", "kmer_counts", "mean_cov"),
             got[0], want[0]),
            ("read paths", ("offsets", "uid", "fwd", "enter", "leave", "pos"),
             got[1], want[1]),
            ("links", ("a", "fla", "b", "flb", "n_pairs", "sep", "dev"),
             got[2], want[2])):
        for f in fields:
            a, b = getattr(x, f), getattr(y, f)
            check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                  f"ulinks at {ULINKS_CMP_GENOME} bp: {name}.{f} card != CPU")
    check(np.array_equal(got[3], want[3]) and len(got[4]) == len(want[4])
          and all(np.array_equal(a, b) for a, b in zip(got[4], want[4])),
          f"ulinks at {ULINKS_CMP_GENOME} bp: seeds or neighbourhoods differ")
    say(f"[lib] ulinks {ULINKS_CMP_GENOME} bp: card == CPU byte for byte "
        f"({got[0].n} unipaths, {got[2].n_edges} links, {got[6]} keys)")
    return n_sort


def kmer_set(g: np.ndarray, K: int) -> set:
    """Every K-mer of g and its reverse complement, as bytes."""
    out = set()
    for i in range(len(g) - K + 1):
        w = g[i:i + K]
        out.add(w.tobytes())
        out.add((3 - w[::-1]).astype(np.uint8).tobytes())
    return out


def clean_frac(reads, gset, K: int = 24, stride: int = 7) -> float:
    """tests/test_ultra.py's clean 24-mer fraction."""
    tot = hit = 0
    for r in reads:
        for i in range(0, len(r) - K + 1, stride):
            tot += 1
            hit += r[i:i + K].tobytes() in gset
    return hit / max(tot, 1)


def tile_assembly(g: np.ndarray, reads, assemble):
    """tests/test_ultra.py's assembly of corrected reads: 250 bp tiles
    every 200 bp (those of >= 100 bp) through assemble(codes) -> contig
    sequences. Returns (tiles, contig lengths longest first, the share of
    g's 100-mers probed every 200 bp found in the contigs)."""
    tiles = [r[s:s + 250] for r in reads
             for s in range(0, max(len(r) - 250 + 1, 1), 200)
             if len(r[s:s + 250]) >= 100]
    codes = np.full((len(tiles), 250), 4, np.uint8)
    for i, t in enumerate(tiles):
        codes[i, :len(t)] = t
    seqs = assemble(codes)
    lens = sorted((len(s) for s in seqs), reverse=True)
    cset = set()
    for s in seqs:
        s = np.asarray(s, np.uint8)
        for i in range(len(s) - 100 + 1):
            cset.add(s[i:i + 100].tobytes())
            cset.add((3 - s[i:i + 100][::-1]).astype(np.uint8).tobytes())
    probes = range(0, len(g) - 100 + 1, 200)
    covered = sum(g[i:i + 100].tobytes() in cset for i in probes) / len(
        probes)
    return len(tiles), lens, covered


def ultra_criterion(timer: StageTimer) -> dict:
    """tests/test_ultra.py's done-criterion on the card at
    ULTRA_CRITERION_GENOME: 15x CLR reads (mean 5 kb, 15 % error), 3
    rounds of Ultra, then LongProto on 250 bp tiles: the clean 24-mer
    fraction, the assembly's total and its 100-mer coverage, each held to
    the test's limit. Returns the timer's totals of the Ultra run."""
    from allpathslg_tpu_torch.eval import sim
    from allpathslg_tpu_torch.long import longproto, ultra

    G = ULTRA_CRITERION_GENOME
    g = sim.random_genome(G, seed=13)
    reads, _, _ = sim.simulate_long_reads(g, coverage=15, mean_len=5000,
                                          error_rate=0.15, seed=17)
    t0 = time.perf_counter()
    cor, metrics = ultra.correct_long_reads(
        reads, ultra.UltraConfig(rounds=3), device="cuda")
    ultra_s = time.perf_counter() - t0
    totals = {name.split(".")[-1]: tot
              for (_, name), tot in timer.totals.items()}
    gset = kmer_set(g, 24)
    before, clean = clean_frac(reads, gset), clean_frac(cor, gset)
    t0 = time.perf_counter()
    n_tiles, lens, covered = tile_assembly(
        g, cor, lambda codes: longproto.long_proto(
            codes, longproto.LongProtoConfig(min_kmer_count=3,
                                             correction_rounds=0),
            device="cuda").contigs.seqs)
    lp_s = time.perf_counter() - t0
    lo, hi = ULTRA_TOTAL
    say(f"[lib] ultra {G} bp: {len(reads)} CLR reads "
        f"({sum(len(r) for r in reads)} bp), clean 24-mers {before:.4f} -> "
        f"{clean:.4f}; {metrics}; Ultra {ultra_s:.1f} s (s: "
        f"{show_terms({k: v[0] for k, v in totals.items()})}); LongProto on "
        f"{n_tiles} tiles and the 100-mer probes {lp_s:.1f} s: total "
        f"{sum(lens)} bp in {len(lens)} contigs (longest "
        f"{lens[0] if lens else 0}), 100-mers covered {covered:.4f}")
    check(clean > ULTRA_MIN_CLEAN, f"ultra {G}: clean fraction {clean}")
    check(lo * G < sum(lens) < hi * G, f"ultra {G}: total {sum(lens)}")
    check(covered > ULTRA_MIN_COVERED, f"ultra {G}: covered {covered}")
    return totals


def lib_ultra() -> int:
    """(d) long/ultra on the card: the reference's done-criterion at
    ULTRA_CRITERION_GENOME, split into friend sort, hit selection, problem
    build, DP forward, traceback and consensus (StageTimer); at
    ULTRA_CMP_GENOME with 2 rounds the card == the CPU byte for byte, and
    the first DP chunk of that run replayed once under torch.profiler for
    its kernel launches and device time. Returns the sort kernel's
    launches in the criterion run."""
    from allpathslg_tpu_torch.eval import sim
    from allpathslg_tpu_torch.long import ultra
    from allpathslg_tpu_torch import trace

    timer = StageTimer(ULTRA_TIMED)
    timer.install()
    trace.reset()
    try:
        with LaunchStages((("long.ultra", "friend_hits", "friends"),)):
            totals = ultra_criterion(timer)
    finally:
        timer.remove()
    by = trace.by_stage()
    n_sort = sum(k.get("radix_sort", 0) for k in by.values())
    check(by.get("friends", {}).get("radix_sort", 0) > 0,
          "ultra: the sort kernel never launched in friend_hits")
    g = sim.random_genome(ULTRA_CMP_GENOME, seed=3)
    reads, _, _ = sim.simulate_long_reads(g, coverage=15, mean_len=4000,
                                          error_rate=0.15, seed=7)
    cfg = ultra.UltraConfig(rounds=2)
    chunks = []
    dp = ultra._banded_votes_kernel

    def keep_first(*a, **kw):
        if not chunks:
            chunks.append((a, kw))
        return dp(*a, **kw)

    ultra._banded_votes_kernel = keep_first
    try:
        t0 = time.perf_counter()
        got = ultra.correct_long_reads(reads, cfg, device="cuda")
        card_s = time.perf_counter() - t0
    finally:
        ultra._banded_votes_kernel = dp
    t0 = time.perf_counter()
    want = ultra.correct_long_reads(reads, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(got[1] == want[1] and len(got[0]) == len(want[0])
          and all(a.tobytes() == b.tobytes()
                  for a, b in zip(got[0], want[0])),
          f"ultra at {ULTRA_CMP_GENOME} bp: card != CPU")
    a, kw = chunks[0]
    _, n_kern, dev_ms = kernel_rows(lambda: dp(*a, **kw), "ultra DP chunk")
    (fwd_s, n_chunks), (tb_s, _) = (totals["_votes_forward"],
                                    totals["_votes_traceback"])
    say(f"[lib] ultra {ULTRA_CMP_GENOME} bp, 2 rounds: card == CPU byte for "
        f"byte ({got[1]}); card {card_s:.1f} s, CPU {cpu_s:.1f} s; the DP "
        f"of one chunk ({a[0].shape[0]} problems, {kw['Lt']} x {kw['Lq']}, "
        f"band {kw['band']}): {n_kern} kernel launches, {dev_ms:.1f} ms of "
        f"them on the device; the criterion run's {n_chunks} chunks "
        f"{(fwd_s + tb_s) / n_chunks * 1e3:.1f} ms each (forward + "
        f"traceback, synchronised); sort kernel launches in the criterion "
        f"run {n_sort}")
    return n_sort


def phase_library(seed: int) -> dict:
    """Phase 12: the library modules on the card, (a) affine, (b)
    mxu_scan, (c) ulinks and (d) Ultra, each part's seconds printed.
    Returns the sort kernel's launches."""
    n_sort = 0
    for part, run in (("affine", lambda: lib_affine(seed)),
                      ("mxu_scan", lambda: lib_mxu(seed)),
                      ("ulinks", lambda: lib_ulinks(seed)),
                      ("ultra", lib_ultra)):
        t0 = time.perf_counter()
        n_sort += run() or 0
        say(f"[lib] {part}: {time.perf_counter() - t0:.1f} s")
    return {"radix_sort": n_sort}


# Phase 13: the mesh (parallel/*) on the card
MESH_SHARDS = 8
MESH_CPU_KEYS = 1 << 20
MESH_RING_ROWS = MESH_SHARDS << 20
MESH_STAGES = ("validate_inputs", "find_errors", "clean_reads", "unipaths")
MESH_TIMING_REPS = 3
SMALL_SORT_KEYS = 1 << 17       # below this the kernel loses to torch.sort


def sorted_histogram(hist) -> dict:
    """{"<2**b": n} in increasing b."""
    return {k: hist[k] for k in sorted(hist, key=lambda k: int(k[4:]))}


def below(hist, size: int) -> int:
    """Calls in the "<2**b" buckets wholly under `size` (a power of two)."""
    return sum(n for k, n in hist.items() if (1 << int(k[4:])) <= size)


class SortLaunches:
    """The sort kernel's launches and key-count histogram over a phase's
    counted calls, each counted from 0 just before it runs."""

    def __init__(self):
        self.n = 0
        self.hist = {}

    def add(self, n: int, hist: dict):
        self.n += n
        for k, v in hist.items():
            self.hist[k] = self.hist.get(k, 0) + v

    def run(self, fn):
        from allpathslg_tpu_torch import trace

        trace.reset()
        out = fn()
        torch.cuda.synchronize()
        self.add(trace.count("radix_sort"),
                 trace.size_histogram("radix_sort"))
        return out


def mesh_legs(codes: np.ndarray, spectrum: torch.Tensor, seed: int,
              counter: SortLaunches) -> dict:
    """13(a): distributed_spectrum, sample_sort and the ring scan on an
    8-shard mesh on the card at the flagship shape, each against its
    1-device counterpart, and sample_sort card == CPU; each leg timed
    beside the 1-device call. Returns the times (ms)."""
    from allpathslg_tpu_torch.kmer import bits, kmerize
    from allpathslg_tpu_torch.models.flagship import spectrum_step
    from allpathslg_tpu_torch.ops import segmented, sort as ops_sort
    from allpathslg_tpu_torch.parallel import dist_count, ring
    from allpathslg_tpu_torch.parallel import mesh as pmesh
    from allpathslg_tpu_torch.parallel import sample_sort as ss

    mesh = pmesh.make_mesh(MESH_SHARDS)
    check(mesh.size == MESH_SHARDS and mesh.platform == "cuda",
          f"make_mesh({MESH_SHARDS}) placed its shards on {mesh.devices}")
    dev = mesh.home
    codes_t = torch.from_numpy(codes).to(dev)
    ms = {}

    def spread():
        return dist_count.distributed_spectrum(mesh, codes_t, FLAGSHIP_K)

    spec, dropped, _, _, nu = counter.run(spread)
    distinct = int(spectrum[1:].sum())
    check(torch.equal(spec.cpu(), spectrum),
          "distributed_spectrum on 8 shards != phase 4's spectrum")
    check(int(dropped) == 0, f"distributed_spectrum dropped {int(dropped)}")
    check(int(nu.sum()) == distinct,
          f"sum of n_unique {int(nu.sum())} != {distinct} distinct kmers")
    ms["distributed_spectrum_ms"] = median_ms(spread, MESH_TIMING_REPS)
    ms["spectrum_step_ms"] = median_ms(
        lambda: spectrum_step(codes_t, K=FLAGSHIP_K), MESH_TIMING_REPS)
    say(f"[mesh] distributed_spectrum, {MESH_SHARDS} shards, "
        f"{codes.shape[0]} x {codes.shape[1]} at K={FLAGSHIP_K}: == phase "
        f"4's spectrum, dropped 0, n_unique per shard {nu.tolist()} (sum "
        f"{distinct}); {ms['distributed_spectrum_ms']:.2f} ms vs "
        f"spectrum_step on one device {ms['spectrum_step_ms']:.2f} ms")

    canon, valid = kmerize.kmer_windows(codes_t, FLAGSHIP_K)
    flat, _ = kmerize.flatten_kmers(canon, valid, FLAGSHIP_K)
    del canon, valid
    pay = torch.arange(flat[0].numel(), dtype=torch.int32, device=dev)

    def mesh_sort():
        return ss.sample_sort(mesh, flat, [pay])

    sw, sp, n_real, n_drop = counter.run(mesh_sort)
    ow, (op,) = ops_sort.sort_by_words(flat, [pay])
    keep_m, keep_1 = ~bits.is_sentinel(sw), ~bits.is_sentinel(ow)
    check(n_drop == 0, f"sample_sort dropped {n_drop}")
    check(int(n_real.sum()) == int(keep_1.sum()),
          "sample_sort n_real != the non-sentinel key count")
    check(all(torch.equal(a[keep_m], b[keep_1]) for a, b in zip(sw, ow))
          and torch.equal(sp[0][keep_m], op[keep_1]),
          "sample_sort, sentinels stripped in shard order, != sort_by_words")
    del sw, sp, ow, op, keep_m, keep_1
    ms["sample_sort_ms"] = median_ms(mesh_sort, MESH_TIMING_REPS)
    ms["sort_by_words_ms"] = median_ms(
        lambda: ops_sort.sort_by_words(flat, [pay]), MESH_TIMING_REPS)
    say(f"[mesh] sample_sort of {flat[0].numel()} two-word keys + int32 "
        f"payload on {MESH_SHARDS} shards == sort_by_words (keys and "
        f"payload, sentinels stripped), n_real {n_real.tolist()}, dropped "
        f"0; {ms['sample_sort_ms']:.2f} ms vs sort_by_words on one device "
        f"{ms['sort_by_words_ms']:.2f} ms")

    sub = [w[:MESH_CPU_KEYS].clone() for w in flat]
    psub = pay[:MESH_CPU_KEYS].clone()
    del flat, pay
    card = ss.sample_sort(mesh, sub, [psub])
    cpu = ss.sample_sort(pmesh.make_mesh(MESH_SHARDS, device="cpu"),
                         [w.cpu() for w in sub], [psub.cpu()])
    check(all(torch.equal(a.cpu(), b) for a, b in
              zip(card[0] + card[1] + [card[2]], cpu[0] + cpu[1] + [cpu[2]]))
          and card[3] == cpu[3],
          "sample_sort on the card != on the CPU")
    say(f"[mesh] sample_sort of {MESH_CPU_KEYS} keys: the card == the CPU "
        f"(plain sort), every array")

    rng = np.random.default_rng(seed + 13)
    vals = torch.from_numpy(rng.integers(0, 1000, MESH_RING_ROWS)
                            .astype(np.int32)).to(dev)
    starts_np = rng.random(MESH_RING_ROWS) < 1e-4
    starts_np[3 << 20:5 << 20] = False      # shards 3 and 4 hold no start
    starts = torch.from_numpy(starts_np).to(dev)

    def ring_scan():
        return ring.ring_segmented_cumsum(mesh, vals, starts)

    got = counter.run(ring_scan)
    check(torch.equal(got, segmented.segment_cumsum(vals, starts)),
          "ring_segmented_cumsum != segment_cumsum")
    ms["ring_ms"] = median_ms(ring_scan, MESH_TIMING_REPS)
    ms["segment_cumsum_ms"] = median_ms(
        lambda: segmented.segment_cumsum(vals, starts), MESH_TIMING_REPS)
    say(f"[mesh] ring_segmented_cumsum of {MESH_RING_ROWS} int32 on "
        f"{MESH_SHARDS} shards (two without a start) == segment_cumsum; "
        f"{ms['ring_ms']:.2f} ms vs {ms['segment_cumsum_ms']:.2f} ms on one "
        f"device")
    return ms


def _link_or_copy(src: str, dst: str):
    """Hard-link a run dir's artifacts (RunDir.save_arrays replaces them by
    rename, never in place); copy every other file, which a stage may
    rewrite in place, with its modification time."""
    if src.endswith(".npz") or ".arrd" + os.sep in src:
        os.link(src, dst)
    else:
        shutil.copy2(src, dst)


def _written(orig: Path, copy: Path):
    """(copy, original) of every file of `copy` that a run in `copy`
    wrote: no longer a hard link of its original, nor a copy with its
    modification time. manifest.json is left out."""
    for p in sorted(copy.rglob("*")):
        if p.is_file() and p.name != "manifest.json":
            q = orig / p.relative_to(copy)
            if not q.exists() or not (
                    p.samefile(q)
                    or p.stat().st_mtime_ns == q.stat().st_mtime_ns):
                yield p, q


def _same_file(p: Path, q: Path) -> bool:
    if not q.exists():
        return False
    if p.suffix == ".npz":       # zip members carry their write time
        with np.load(p) as a, np.load(q) as b:
            return sorted(a.files) == sorted(b.files) and all(
                a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                and a[k].tobytes() == b[k].tobytes() for k in a.files)
    return p.read_bytes() == q.read_bytes()


def mesh_stages(full_dir: Path, counter: SortLaunches) -> dict:
    """13(b): phase 8's run dir copied (its artifacts hard-linked), the
    records and outputs of MESH_STAGES dropped, those stages run on an
    8-shard mesh on the card; every file they write must equal phase 8's
    and so must their metrics. Returns {stage: seconds}."""
    from allpathslg_tpu_torch.parallel import dist_count
    from allpathslg_tpu_torch.pipeline.config import AssemblyConfig
    from allpathslg_tpu_torch.pipeline.rundir import RunDir
    from allpathslg_tpu_torch.pipeline.stages import Pipeline

    mesh_dir = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(mesh_dir, ignore_errors=True)
    shutil.copytree(full_dir, mesh_dir, copy_function=_link_or_copy)
    full = RunDir(str(full_dir))
    rd = RunDir(str(mesh_dir))
    outputs = {s: full.manifest["stages"][s]["outputs"] for s in MESH_STAGES}
    for stage in MESH_STAGES:
        for out in outputs[stage]:
            for path in (mesh_dir / out, mesh_dir / (out[:-4] + ".arrd")):
                if path.is_dir():
                    shutil.rmtree(path)
                elif path.exists():
                    path.unlink()
        del rd.manifest["stages"][stage]
    (mesh_dir / "manifest.json").unlink()
    (mesh_dir / "manifest.json").write_text(json.dumps(rd.manifest))
    logged = []
    pipe = Pipeline(rd, AssemblyConfig.from_overrides(n_devices=MESH_SHARDS),
                    logged.append, device="cuda")
    check(f"[pipeline] mesh: {MESH_SHARDS} devices (cuda)" in logged,
          f"the mesh Pipeline logged {logged[:1]}")
    ici = {}
    for stage in MESH_STAGES:
        counter.run(getattr(pipe, stage))
        if stage == "validate_inputs":
            ici[stage] = dist_count.count_reads_streaming_dist.last_ici_bytes
        elif stage == "find_errors":
            ici[stage] = \
                dist_count.count_resident_streaming_dist.last_ici_bytes
    written = list(_written(full_dir, mesh_dir))
    bad = [str(p.relative_to(mesh_dir)) for p, q in written
           if not _same_file(p, q)]
    check(not bad, f"mesh stages wrote files that differ from phase 8's: "
          f"{bad}")
    names = {str(p.relative_to(mesh_dir)) for p, _ in written}
    for stage in MESH_STAGES:
        for out in outputs[stage]:
            check(any(n == out or n.startswith(out[:-4] + ".arrd/")
                      for n in names), f"{stage} did not rewrite {out}")
        check(rd.metrics(stage) == full.metrics(stage),
              f"{stage}'s metrics on the mesh differ from phase 8's")
    secs = {}
    for stage in MESH_STAGES:
        secs[stage] = rd.manifest["stages"][stage]["elapsed_s"]
        say(f"[mesh] {stage}: {secs[stage]:.1f} s on {MESH_SHARDS} shards "
            f"vs {full.manifest['stages'][stage]['elapsed_s']:.1f} s on one "
            f"device in phase 8 (stage_workers 2 there); metrics equal"
            + (f"; last all_to_all model {ici[stage]} B off a shard"
               if stage in ici else ""))
    say(f"[mesh] run_full's mesh-routed stages at 4.6 Mb: {len(written)} "
        f"files written, each == phase 8's ({sorted(names)})")
    shutil.rmtree(mesh_dir, ignore_errors=True)
    return secs


MESH_CHILD = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
pid, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from allpathslg_tpu_torch import trace
from allpathslg_tpu_torch.parallel import multihost as mh
from allpathslg_tpu_torch.parallel.dist_count import distributed_spectrum
mh.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
              process_id=pid, backend="gloo")
mesh = mh.global_mesh(4, device="cuda")
assert (mesh.size, mesh.rank, mesh.backend) == (8, pid, "gloo"), mesh
codes = np.load(d + "/codes.npy")
rows = codes.shape[0] // 2
local = mh.host_batch_to_global(codes[pid * rows:(pid + 1) * rows], mesh)
trace.reset()
t0 = time.perf_counter()
spec, dropped, _, _, nu = distributed_spectrum(mesh, local, K=24)
torch.cuda.synchronize()
secs = time.perf_counter() - t0
parts = [torch.zeros_like(nu.cpu()) for _ in range(2)]
dist.all_gather(parts, nu.cpu())
np.savez(f"{d}/out{pid}.npz", spec=spec.cpu().numpy(),
         nu=torch.cat(parts).numpy())
print(json.dumps({"pid": pid, "dropped": int(dropped), "secs": secs,
                  "launches": trace.count("radix_sort"),
                  "sizes": trace.size_histogram("radix_sort")}),
      flush=True)
dist.destroy_process_group()
"""


def mesh_two_processes(codes: np.ndarray, spectrum: torch.Tensor,
                       counter: SortLaunches) -> float:
    """13(c): two processes of 4 shards each on the card over gloo (each
    exchange staged through host memory) hold the flagship batch's spectrum
    against phase 4's. Returns the slower process's seconds."""
    import socket

    d = ROOT / "build" / "chip_smoke_multihost"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    np.save(d / "codes.npy", codes)
    (d / "child.py").write_text(MESH_CHILD)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(d / "child.py"), str(pid), str(port), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(ROOT), text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multihost process {pid} failed:\n"
              f"{out[-3000:]}")
    distinct = int(spectrum[1:].sum())
    secs = []
    for pid, out in enumerate(outs):
        rec = json.loads(out.strip().splitlines()[-1])
        got = np.load(d / f"out{pid}.npz")
        check(rec["dropped"] == 0, f"process {pid} dropped {rec['dropped']}")
        check(np.array_equal(got["spec"], spectrum.numpy()),
              f"process {pid}'s spectrum != phase 4's")
        check(int(got["nu"].sum()) == distinct,
              f"process {pid}: n_unique sum {int(got['nu'].sum())} != "
              f"{distinct}")
        counter.add(rec["launches"], rec["sizes"])
        secs.append(rec["secs"])
        say(f"[mesh] process {pid} of 2 (4 shards on the card, gloo, "
            f"staged through host memory): spectrum == phase 4's, n_unique "
            f"{got['nu'].tolist()}, {rec['secs']:.2f} s, sort launches "
            f"{rec['launches']}")
    shutil.rmtree(d, ignore_errors=True)
    return max(secs)


def phase_mesh(codes: np.ndarray, spectrum: torch.Tensor, full_dir: Path,
               seed: int) -> dict:
    """Phase 13: (a) the mesh legs at the flagship shape, (b) run_full's
    mesh-routed stages at 4.6 Mb against phase 8, (c) the two-process
    spectrum. Returns the record: sort launches and key counts of the
    counted calls, the legs' times, the stages' seconds."""
    counter = SortLaunches()
    t0 = time.perf_counter()
    ms = mesh_legs(codes, spectrum, seed, counter)
    say(f"[mesh] (a) legs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    secs = mesh_stages(full_dir, counter)
    say(f"[mesh] (b) stages: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    two = mesh_two_processes(codes, spectrum, counter)
    say(f"[mesh] (c) two processes: {time.perf_counter() - t0:.1f} s")
    check(counter.n > 0, "phase 13 launched no sort kernel")
    hist = sorted_histogram(counter.hist)
    say(f"[mesh] sort launches {counter.n}, by key count {hist}; "
        f"{below(hist, SMALL_SORT_KEYS)} under 2**17 keys")
    return {"launches": counter.n, "key_counts": hist, **ms,
            "stage_s": secs, "two_process_s": two}


# Phase 14: the count engines (ops/bucket_count on csrc/row_sort.cu)
ROW_SORT_SHAPES = (("K=24 tiles", 127, 131_072), ("K=24 slabs", 127, 196_723),
                   ("K=96 tiles", 55, 131_072), ("K=96 slabs", 55, 196_625))
ROW_SORT_ODD = ((1, 99_999), (3, 12_345), (1, 1))
GROUPED_KEYS = 1 << 20
TUNE_TIMEOUT_S = 300


def row_sort_bound_ms(n_keys: int) -> float:
    """The least time of a sort of n_keys keys: 8 B of key read, 8 B of key
    and 4 B of index written, each once, over the memory rate."""
    return 20 * n_keys / HBM_BYTES_PER_S * 1e3


def random_rows(rows: int, row_len: int, key_bits: int, gen) -> torch.Tensor:
    """Random keys of key_bits bits [rows, row_len] on the card, 1 % of
    them all-ones."""
    from allpathslg_tpu_torch.ops.cuda import sort_cuda

    shape, dev = (rows, row_len), torch.device("cuda")
    keys = torch.randint(0, 1 << 32, shape, generator=gen, device=dev)
    if key_bits == 64:
        keys = (keys << 32) | torch.randint(0, 1 << 32, shape,
                                            generator=gen, device=dev)
    ones = torch.rand(shape, generator=gen, device=dev) < 0.01
    return torch.where(ones, sort_cuda.all_ones(key_bits), keys)


def row_sort_timed(keys: torch.Tensor, key_bits: int) -> dict:
    """Kernel, plain version and torch.sort(dim=1) in turns (median_ms),
    with the byte bound."""
    from allpathslg_tpu_torch.ops.cuda import row_sort_cuda

    flipped = keys ^ (-(1 << 63))

    def plain():
        return row_sort_cuda.row_sort_plain(keys, key_bits)

    def kernel():
        return row_sort_cuda.row_sort(keys, key_bits)

    def library():
        return torch.sort(flipped, dim=1)

    t = [median_ms(f) for f in (plain, kernel, library, library, kernel,
                                plain)]
    return {"ms": min(t[1], t[4]), "plain_ms": min(t[0], t[5]),
            "library_ms": min(t[2], t[3]),
            "bound_ms": row_sort_bound_ms(keys.numel()), "bound_by": "bytes"}


def row_sort_hard_cases(gen) -> list:
    """(what, keys, key_bits) of the shapes and key sets a row-scoped
    one-sweep sort can get wrong (tests/test_torch_bucket_count.py's
    _row_case, on the card): rows of one tile, rows that end mid-tile,
    rows whose keys share a bucket in every digit while other rows
    differ, K=24 keys with zero low 16 bits, rows of sentinels only."""
    one_bucket = random_rows(5, 9000, 64, gen)
    one_bucket[1] = one_bucket[0, 0]
    one_bucket[2] = one_bucket[0, 1]
    one_bucket[2, ::97] = -1
    k24 = random_rows(6, 20_000, 64, gen)
    k24 = torch.where(k24 == -1, k24, k24 & ~0xFFFF)
    sentinel = random_rows(5, 7000, 64, gen)
    sentinel[[0, 3]] = -1
    return [("4,096 rows of 600", random_rows(4096, 600, 64, gen), 64),
            ("3 x 6,145, rows ending mid-tile", random_rows(3, 6145, 64,
                                                            gen), 64),
            ("rows 1 and 2 of one key (+ sentinels)", one_bucket, 64),
            ("K=24 keys, low 16 bits zero", k24, 64),
            ("rows 0 and 3 sentinels only", sentinel, 64),
            ("300 x 2,500, 1 word", random_rows(300, 2500, 32, gen), 32)]


def flagship_tiles(flat) -> torch.Tensor:
    """The flagship's 2-word K=24 keys as group_keys' tiles [T, R]."""
    from allpathslg_tpu_torch.ops import bucket_count

    n_pad, R, _, _ = bucket_count.grouping_plan(flat[0].numel())
    w0, w1 = bucket_count._pad_to(flat, n_pad)
    return ((w0 << 32) | w1).reshape(n_pad // R, R)


def row_sort_split(keys: torch.Tensor, reps: int = 5) -> dict:
    """Device ms a sort of keys (2 words) by the row sort's kernels,
    torch.profiler over reps sorts (profiled again, up to
    PROFILE_ATTEMPTS times, when it recorded no pass kernel): {"histogram",
    "bases", "passes", "memset", "device", "pass_launches"}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from allpathslg_tpu_torch.ops.cuda import row_sort_cuda

    row_sort_cuda.row_sort(keys, 64)
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                row_sort_cuda.row_sort(keys, 64)
            torch.cuda.synchronize()
        split = dict.fromkeys(("histogram", "bases", "passes", "memset",
                               "pass_launches"), 0.0)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = e.self_device_time_total / 1e3 / reps
            for part, name in (("histogram", "::histogram_kernel"),
                               ("bases", "::bases_kernel"),
                               ("passes", "::pass_kernel"),
                               ("memset", "Memset")):
                if name in e.key:
                    split[part] += ms
                    if part == "passes":
                        split["pass_launches"] += e.count / reps
        if split["passes"] > 0:
            break
    split["device"] = sum(split[k] for k in ("histogram", "bases", "passes",
                                             "memset"))
    check(split["passes"] > 0, "row_sort_split: no pass kernel recorded")
    return split


# torch.profiler can lose kernel rows late in a long process (phases 7 and
# 12 trace), so the split runs in a process of its own
ROW_SORT_SPLIT_CHILD = r"""
import json, sys
import torch
import chip_smoke as smoke
from allpathslg_tpu_torch.kmer import count as kcount
codes = torch.from_numpy(smoke.flagship_codes(int(sys.argv[1]))).cuda()
tiles = smoke.flagship_tiles(kcount._kmer_flat(codes, smoke.FLAGSHIP_K))
print(json.dumps(smoke.row_sort_split(tiles)), flush=True)
"""


def row_sort_split_child(seed: int) -> dict:
    """row_sort_split of the flagship tiles (flagship_codes(seed)) in a
    child process."""
    proc = subprocess.run(
        [sys.executable, "-c", ROW_SORT_SPLIT_CHILD, str(seed)], cwd=ROOT,
        capture_output=True, text=True, timeout=TUNE_TIMEOUT_S)
    check(proc.returncode == 0,
          f"row sort split child failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def row_sort_parity(flat, seed: int) -> dict:
    """14(a): the row sort against its plain version, exactly, and timed;
    returns {"max_abs_err", timed record of the flagship tiles with its
    device split, "shapes": {label: timed}}."""
    from allpathslg_tpu_torch.ops.cuda import row_sort_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    max_err = 0

    def held(keys, key_bits, what, idx=None):
        nonlocal max_err
        got = row_sort_cuda.row_sort(keys, key_bits, idx)
        want = row_sort_cuda.row_sort_plain(keys, key_bits, idx)
        err = sort_err(got, want)
        check(err == 0 and torch.equal(got[0], want[0])
              and torch.equal(got[1], want[1]), f"row sort != plain on {what}")
        max_err = max(max_err, err)

    def row_perms(keys):
        return torch.argsort(torch.rand(keys.shape, generator=gen,
                                        device="cuda"), dim=1).int()

    def show(what, tm):
        say(f"[rowsort] {what}: kernel {tm['ms']:.3f} ms, plain "
            f"{tm['plain_ms']:.3f}, torch.sort(dim=1) {tm['library_ms']:.3f}"
            f", bound {tm['bound_ms']:.4f} ({100 * tm['bound_ms'] / tm['ms']:.1f}"
            f" % of the kernel's time)")

    tiles = flagship_tiles(flat)
    held(tiles, 64, "the flagship's K=24 tiles")
    held(tiles, 64, "the flagship's K=24 tiles, initial index",
         row_perms(tiles))
    got, want = (row_sort_cuda.row_histogram(tiles, 64),
                 row_sort_cuda.row_histogram_plain(tiles, 64))
    check(all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
          and np.array_equal(got.union, want.union)
          and got.n_ones == want.n_ones,
          "row sort's histogram and bases kernels != plain on the tiles")
    record = row_sort_timed(tiles, 64)
    show(f"flagship K=24 tiles {tiles.shape[0]} x {tiles.shape[1]}, == "
         f"plain (also with an initial index; histogram and bases == "
         f"plain)", record)
    split = row_sort_split_child(seed)
    say(f"[rowsort] flagship K=24 tiles, device ms a sort (torch.profiler, "
        f"5 sorts, child process): histogram {split['histogram']:.4f}, bases "
        f"{split['bases']:.4f}, passes {split['passes']:.4f} "
        f"({split['pass_launches']:g} launches), memset "
        f"{split['memset']:.4f}; device {split['device']:.4f} of the "
        f"kernel's {record['ms']:.3f} ms")
    record.update({f"split_{k}_ms": v for k, v in split.items()
                   if k != "pass_launches"})
    shapes = {}
    for label, rows, row_len in ROW_SORT_SHAPES:
        for key_bits in (32, 64):
            keys = random_rows(rows, row_len, key_bits, gen)
            what = f"{label} {rows} x {row_len}, {key_bits // 32} word(s)"
            held(keys, key_bits, what)
            shapes[f"{label} {key_bits // 32}w"] = tm = row_sort_timed(
                keys, key_bits)
            show(f"{what}, 1 % all-ones, == plain", tm)
    for rows, row_len in ROW_SORT_ODD:
        for key_bits in (32, 64):
            held(random_rows(rows, row_len, key_bits, gen), key_bits,
                 f"odd {rows} x {row_len}")
    sent = random_rows(3, 5_000, 64, gen)
    sent[0] = -1
    sent[2] = -1
    held(sent, 64, "rows 0 and 2 all sentinels")
    held(torch.full((4, 5_000), -1, dtype=torch.int64, device="cuda"), 64,
         "every row all sentinels")
    held(torch.full((4, 5_000), 0xFFFFFFFF, dtype=torch.int64,
                    device="cuda"), 32, "every row all sentinels, 1 word")
    say(f"[rowsort] odd rows {ROW_SORT_ODD} and all-sentinel rows: == plain")
    hard = row_sort_hard_cases(gen)
    for what, keys, key_bits in hard:
        held(keys, key_bits, what)
        held(keys, key_bits, f"{what}, initial index", row_perms(keys))
    say(f"[rowsort] {'; '.join(w for w, _, _ in hard)}: == plain, with "
        f"and without an initial index")
    return {"max_abs_err": max_err, **record, "shapes": shapes}


def same_table(a, b) -> bool:
    """Two compact tables hold the same keys and counts (their padding may
    differ in length)."""
    n = int(a.n_unique)
    return (n == int(b.n_unique)
            and all(torch.equal(x[:n], y[:n]) for x, y in zip(a.words,
                                                               b.words))
            and torch.equal(a.counts[:n], b.counts[:n]))


def grouped_attempt(fn):
    """Runs count_grouped on 2-word keys through fn() and names what
    returned, from the launches it made: each grouping attempt is 2 row
    sorts and one sample sort; the flat fallback adds count_sorted's sort."""
    from allpathslg_tpu_torch import trace

    trace.reset()
    out = fn()
    torch.cuda.synchronize()
    rows = trace.count("row_sort")
    attempts = rows // 2
    check(attempts >= 1 and rows == 2 * attempts,
          f"count_grouped made {rows} row sorts")
    return out, (f"attempt {attempts}"
                 if trace.count("radix_sort") == attempts
                 else f"flat fallback after {attempts} attempts")


def count_engines(codes: np.ndarray, spectrum: torch.Tensor) -> dict:
    """14(b) and (c), the counted main path: spectrum_reads_auto on the
    bucketed engine and count_grouped at K=24 and K=96 against
    count_sorted. Returns the launches of both kernels."""
    from allpathslg_tpu_torch.kmer import count as kcount, kmerize
    from allpathslg_tpu_torch.ops import bucket_count
    from allpathslg_tpu_torch import trace

    cuda_codes = torch.from_numpy(codes).cuda()
    with mock.patch.dict(os.environ, {"APLG_COUNT_ENGINE": "bucketed"}):
        trace.reset()
        spec, nu = kcount.spectrum_reads_auto(cuda_codes, FLAGSHIP_K)
        torch.cuda.synchronize()
    rows, flat_sorts = trace.count("row_sort"), trace.count("radix_sort")
    check(torch.equal(spec.cpu(), spectrum) and int(nu) == int(spectrum.sum()),
          "spectrum_reads_auto (bucketed) != phase 4's spectrum")
    check(rows == 2 and flat_sorts == 1,
          f"spectrum_reads_auto made {rows} row sorts and {flat_sorts} flat "
          f"sorts: not the bucketed path alone")
    launched = {"row_sort": rows, "radix_sort": flat_sorts}

    def counted(fn):
        trace.reset()
        out = fn()
        torch.cuda.synchronize()
        for k in launched:
            launched[k] += trace.count(k)
        return out

    flat24 = kcount._kmer_flat(cuda_codes, FLAGSHIP_K)
    n24 = flat24[0].numel()
    N, R, B, S = bucket_count.grouping_plan(n24)
    _, max_run = counted(lambda: bucket_count.group_keys(
        bucket_count._pad_to(flat24, N), R, B, S))
    check(int(max_run) <= S, f"max_run {int(max_run)} > slots {S}")
    say(f"[engines] (b) spectrum_reads_auto, bucketed: {n24} keys, plan N="
        f"{N} R={R} B={B} S={S}; ok True (max_run {int(max_run)} <= slots "
        f"{S}); 2 row sorts + 1 sample sort, no flat fallback; spectrum == "
        f"phase 4's, n_unique {int(nu)}")
    for K in (FLAGSHIP_K, 96):
        flat = flat24 if K == FLAGSHIP_K else kmerize.flatten_kmers(
            *kmerize.kmer_windows(cuda_codes, K), K)[0]
        got = counted(lambda: kcount.compact_table(
            *bucket_count.count_grouped(flat)))
        want = kcount.compact_table(*kcount.count_sorted(flat))
        check(same_table(got, want),
              f"count_grouped's table != count_sorted's at K={K}")
        say(f"[engines] ({'b' if K == FLAGSHIP_K else 'c'}) K={K}: "
            f"{flat[0].numel()} keys of {len(flat)} words; count_grouped's "
            f"compacted table == count_sorted's ({int(got.n_unique)} "
            f"distinct)")
    return launched


def grouped_card_vs_cpu(flat24):
    """14(d): count_grouped on the card == on the CPU, every array, at
    GROUPED_KEYS keys, with the attempt that returned."""
    from allpathslg_tpu_torch.ops import bucket_count

    rng = np.random.default_rng(14)
    n = GROUPED_KEYS
    small = {"tile_rows": 1024, "n_buckets": 8}   # tests/test_bucket_count.py
    inputs = (
        ("K=24 keys", [w[:n] for w in flat24], {}, "attempt 1"),
        ("7 x 3 distinct keys",
         [torch.from_numpy(rng.integers(0, 7, n)).cuda(),
          torch.from_numpy(rng.integers(0, 3, n)).cuda()], small,
         "attempt 2"),
        ("one repeated key", [torch.zeros(n, dtype=torch.int64,
                                          device="cuda")] * 2, small,
         "flat fallback after 2 attempts"))
    for label, words, kw, want in inputs:
        got, attempt = grouped_attempt(
            lambda: bucket_count.count_grouped(words, **kw))
        cpu = bucket_count.count_grouped([w.cpu() for w in words], **kw)
        same = (all(torch.equal(a.cpu(), b) for a, b in zip(got[0], cpu[0]))
                and torch.equal(got[1].cpu(), cpu[1])
                and torch.equal(got[2].cpu(), cpu[2]))
        check(same, f"count_grouped card != CPU on {label}")
        check(attempt == want, f"count_grouped on {label}: {attempt}, "
              f"want {want}")
        say(f"[engines] (d) {label}, {n} keys ({kw or 'defaults'}): card "
            f"== CPU (words, counts, starts); returned at {attempt}")


def tune_child() -> dict:
    """14(e): tune_count --dry in a child process; its JSON result."""
    user_file = ROOT / "build" / "chip_smoke_tuning.json"
    user_file.unlink(missing_ok=True)
    env = dict(os.environ, APLG_TUNING_FILE=str(user_file))
    proc = subprocess.run(
        [sys.executable, "-m", "allpathslg_tpu_torch.tune_count", "--dry"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=TUNE_TIMEOUT_S)
    check(proc.returncode == 0,
          f"tune_count --dry failed:\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not user_file.exists() and "wrote" not in res,
          "tune_count --dry wrote a tuning file")
    check(res["bucketed_ms"] is not None,
          "tune_count: the bucketed engine overflowed at the flagship shape")
    for line in proc.stderr.strip().splitlines():
        say(f"[tune] {line}")
    return res


def phase_count_engines(codes: np.ndarray, spectrum: torch.Tensor,
                        seed: int) -> dict:
    """Phase 14 on flagship_codes(seed); returns the row sort's record and
    both kernels' launches in the counted main path ((b) and (c))."""
    from allpathslg_tpu_torch.kmer import count as kcount

    flat24 = kcount._kmer_flat(torch.from_numpy(codes).cuda(), FLAGSHIP_K)
    t0 = time.perf_counter()
    record = row_sort_parity(flat24, seed)
    say(f"[engines] (a) row sort: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launched = count_engines(codes, spectrum)
    check(launched["row_sort"] > 0, "phase 14 launched no row sort")
    say(f"[engines] (b, c) main path: {time.perf_counter() - t0:.1f} s; "
        f"launches {launched}")
    t0 = time.perf_counter()
    grouped_card_vs_cpu(flat24)
    say(f"[engines] (d) card == CPU: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tuned = tune_child()
    say(f"[engines] (e) tune_count --dry on this card: flat "
        f"{tuned['flat_ms']:.3f} ms a batch ({tuned['flat_mkmers_s']:.1f} M "
        f"k-mers/s), bucketed {tuned['bucketed_ms']:.3f} ms "
        f"({tuned['bucketed_mkmers_s']:.1f} M k-mers/s): winner "
        f"{tuned['winner']}; {time.perf_counter() - t0:.1f} s")
    record.update({"flat_engine_ms": tuned["flat_ms"],
                   "bucketed_engine_ms": tuned["bucketed_ms"],
                   "tuner_winner": tuned["winner"]})
    return {"record": record, "launches": launched}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-size", type=int, default=200_000,
                    help="genome of the contig-slice phase (7)")
    ap.add_argument("--full-genome-size", type=int, default=4_600_000,
                    help="genome of the run_full phase (8)")
    ap.add_argument("--diploid-genome-size", type=int, default=250_000,
                    help="haplotype of the diploid run_full phase (10)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="run phases 1-6 and only these of 7, 8, 9, 9b, 10, "
                         "11, 12, 13 and 14 (comma-separated; 13 runs 8 "
                         "too), "
                         "to rehearse them; the default runs every phase")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))

    def wanted(phase: str) -> bool:
        return not only or phase in only

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
    spectrum = phase_spectrum(codes)
    done("4 spectrum")
    set_a_record = phase_banded(args.seed, int_rate)
    done("5 bit-parallel DP")
    general_record = phase_banded_general(args.seed, int_rate, chain)
    done("6 general DP")
    pileup_record = phase_pileup(args.seed)
    done("6b pileup")
    kernels = ("radix_sort", "banded_bp", "banded_general", "pileup")
    launched = dict.fromkeys(kernels, 0)

    def add(counts: dict):
        for k in kernels:
            launched[k] += counts.get(k, 0)

    def add_by_stage(by_stage: dict):
        for counts in by_stage.values():
            add(counts)

    if wanted("7"):
        sl = phase_slice(args.genome_size, args.seed)
        add({"radix_sort": sl["sort"], "banded_bp": sl["banded"]})
        done("7 contig slice, traced")
    bp_record = {"max_abs_err": 0, "library_ms": None}
    general_full = {"max_abs_err": 0}
    sizes8 = {}
    cpu_phases = [p for p in ("9", "9b") if wanted(p)]
    cpu_proc = start_cpu_runs(args.seed, cpu_phases) if cpu_phases else None
    if wanted("8") or wanted("13"):         # phase 13 reruns phase 8's stages
        capture = DPCapture()
        total8, sizes8 = phase_full(args.full_genome_size, args.seed, capture,
                                    keep=wanted("13"))
        add(total8)
        bp_record, general_full = phase_dp_batches(capture, int_rate, chain)
        done("8 run_full from files")
    cpu_walls = cpu_runs_result(cpu_proc) if cpu_phases else {}
    if wanted("9"):
        add_by_stage(phase_cli_compare(args.seed, cpu_walls["9"]))
        done("9 card == CPU through the CLI, N-bearing reads")
    if wanted("9b"):
        add_by_stage(phase_long_compare(cpu_walls["9b"]))
        done("9b card == CPU, long reads")
    err10 = {"banded_bp": 0, "banded_general": 0}
    bp10, general10 = {}, {"long_read_patch": [], "assisted": []}
    if wanted("10"):
        capture10 = DPCapture(keep_per_stage=DIPLOID_KEEP_PER_STAGE)
        add(phase_diploid(args.diploid_genome_size, capture10))
        err10, bp10, general10 = phase_dp_diploid(capture10, int_rate, chain)
        done("10 diploid multi-library run_full")
    if wanted("11"):
        add(phase_tools(codes, spectrum, args.seed))
        done("11 tools CLI")
    if wanted("12"):
        add(phase_library(args.seed))
        done("12 library modules")
    mesh_record = {}
    if wanted("13"):
        mesh_record = phase_mesh(codes, spectrum, FULL_DIR, args.seed)
        shutil.rmtree(FULL_DIR, ignore_errors=True)
        add({"radix_sort": mesh_record["launches"]})
        done("13 mesh")
    row_record = {"max_abs_err": 0, "ms": None, "plain_ms": None,
                  "library_ms": None, "bound_ms": None, "bound_by": "bytes"}
    launched14 = {"row_sort": 0, "radix_sort": 0}
    if wanted("14"):
        engines = phase_count_engines(codes, spectrum, args.seed)
        row_record, launched14 = engines["record"], engines["launches"]
        add({"radix_sort": launched14["radix_sort"]})
        done("14 count engines")
    record.update({
        "phase8_key_counts": sizes8,
        "phase8_sorts_under_2**17": below(sizes8, SMALL_SORT_KEYS),
        "phase13_launches": mesh_record.pop("launches", 0),
        "phase13_key_counts": mesh_record.pop("key_counts", {}),
        "phase14_launches": launched14["radix_sort"],
        **{f"mesh_{k}": v for k, v in mesh_record.items()}})
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
        "launches": launched["radix_sort"],
        **record}, {
        "name": "row_sort", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/row_sort.cu",
        "replaces": "allpathslg_tpu/ops/bucket_count.py:73, :117",
        "launches": launched14["row_sort"],
        **row_record}, {
        "name": "banded_bp", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/banded_bp.cu",
        "replaces": "allpathslg_tpu/ops/pallas/banded_bp.py:294",
        "launches": launched["banded_bp"],
        **bp_record, **set_a_record}, {
        "name": "banded_general", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/banded_general.cu",
        "replaces": "allpathslg_tpu/ops/pallas/banded_pallas.py:127",
        "launches": launched["banded_general"],
        **general_record,
        **general_full}, {
        "name": "pileup", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/pileup.cu",
        "replaces": "allpathslg_tpu/asm/polish.py:42 (host numpy)",
        "launches": launched["pileup"],
        **pileup_record}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (allpathslg_tpu_torch).

    python3 chip_smoke.py [--genome-size N] [--seed S]

Needs one CUDA GPU (it raises without one) and `nvcc`; it imports nothing
of JAX or of the JAX package. Phases, each printed as it ends:

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the Hopper radix sort (csrc/radix_sort.cu) with nvcc for sm_90a;
  3. sort parity on the card at the flagship's shape (131,072 reads x
     150 bp at K=24: 16,646,144 two-word keys): the kernel against its
     plain PyTorch version, exactly, with many duplicate keys and with
     sentinels; keys of one and three words and an int32 payload through
     ops/sort.sort_by_words against the same call on the CPU (where it
     takes the plain version); median times of kernel and plain version;
  4. spectrum_step(K=24) on the same batch, against the CPU spectrum;
  5. the error-correction front of the contig slice through
     Pipeline(device="cuda"): prepare_sim_inputs -> validate_inputs ->
     remove_dodgy -> precorrect -> find_errors -> clean_reads on a
     simulated genome (default 4.6 Mb, 100x fragment coverage, 100 bp
     reads, 0.5 % error, seed 0, batch_reads 65536). It checks that the
     sort kernel ran in validate_inputs, precorrect and find_errors, that
     the 25-mer genome-size estimate is within 20 % of the truth, that
     corrections were made, and that the sampled fraction of true 24-mers
     rises from the input reads to the cleaned reads.

Any failed check raises, so the exit code is not 0. The line before the
last is the kernel record {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
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


def say(*a):
    print(*a, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of fn() over reps launches (CUDA events)."""
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


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    name = torch.cuda.get_device_name(0)
    say(f"[card] torch device: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card, name


def phase_build():
    from allpathslg_tpu_torch.ops.cuda import sort_cuda

    path, secs = sort_cuda.build()
    sort_cuda.library()
    say(f"[build] {path.name}: nvcc {secs:.2f} s "
        f"({'cached' if secs == 0.0 else 'built from source'})")


def flagship_codes(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (FLAGSHIP_READS, FLAGSHIP_LEN)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.002] = 4   # N bases: sentinel keys
    return codes


def phase_sort(codes: np.ndarray, seed: int):
    """Kernel vs plain version at the flagship shape; returns the record."""
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
    for label, words in (("flagship K=24 keys with sentinels", flat),
                         ("duplicate-heavy keys", dup)):
        key = (words[0] << 32) | words[1]
        got, gperm = sort_cuda.radix_sort(key, 64)
        want, wperm = sort_cuda.radix_sort_plain(key, 64)
        err = max(int((got - want).abs().max()),
                  int((gperm.long() - wperm.long()).abs().max()))
        check(err == 0, f"kernel != plain sort on {label}")
        max_err = max(max_err, err)
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

    key = (flat[0] << 32) | flat[1]
    plain_ms = median_ms(lambda: sort_cuda.radix_sort_plain(key, 64))
    kernel_ms = median_ms(lambda: sort_cuda.radix_sort(key, 64))
    plain_ms_2 = median_ms(lambda: sort_cuda.radix_sort_plain(key, 64))
    kernel_ms_2 = median_ms(lambda: sort_cuda.radix_sort(key, 64))
    say(f"[sort] {n} K=24 keys, median of {TIMING_REPS}, in turns "
        f"plain/kernel/plain/kernel: plain {plain_ms:.3f} / "
        f"{plain_ms_2:.3f} ms, kernel {kernel_ms:.3f} / {kernel_ms_2:.3f} ms")
    return {"max_abs_err": max_err, "ms": min(kernel_ms, kernel_ms_2),
            "plain_ms": min(plain_ms, plain_ms_2)}


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


def phase_slice(genome_size: int, seed: int):
    from allpathslg_tpu_torch.ops.cuda import sort_cuda
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
    pipe = Pipeline(rd, cfg, quiet, device="cuda")
    sort_cuda.reset_launch_count()
    metrics, launches = {}, {}
    for stage in ("validate_inputs", "remove_dodgy", "precorrect",
                  "find_errors", "clean_reads"):
        before = sort_cuda.launch_count()
        t = time.perf_counter()
        metrics[stage] = getattr(pipe, stage)()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[stage] = sort_cuda.launch_count() - before
        shown = {k: v for k, v in metrics[stage].items() if k != "libraries"}
        say(f"[slice] {stage}: {dt:.1f} s, sort kernel launches "
            f"{launches[stage]}, {shown}")
    total_launches = sort_cuda.launch_count()
    for stage in ("validate_inputs", "precorrect", "find_errors"):
        check(launches[stage] > 0, f"{stage} never launched the sort kernel")

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
    shutil.rmtree(run_dir, ignore_errors=True)
    return total_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-size", type=int, default=4_600_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script only runs "
                         "on a GPU")
    sys.path.insert(0, str(ROOT))
    card, name = phase_card()
    phase_build()
    codes = flagship_codes(args.seed)
    record = phase_sort(codes, args.seed)
    phase_spectrum(codes)
    launches = phase_slice(args.genome_size, args.seed)
    say(json.dumps({"kernels": [{
        "name": "radix_sort_u64", "route": "cuda",
        "source": "allpathslg_tpu_torch/csrc/radix_sort.cu",
        "replaces": "allpathslg_tpu/ops/pallas/sort_pallas.py:178",
        "launches": launches, **record}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

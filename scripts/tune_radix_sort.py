#!/usr/bin/env python3
"""Build variants of the Hopper radix sort and time them on the card.

    python3 scripts/tune_radix_sort.py [--variants kItems=16 kItems=24,...]
                                       [--ptxas] [--profile]

A variant is a comma-separated list of NAME=VALUE; each sets the constant
`constexpr int NAME` (kItems: keys per thread in a pass, a tile being 256 x
kItems keys; kPassBlocksPerSm; kHistBlocks; kHistChunks) in a copy of
allpathslg_tpu_torch/csrc/radix_sort.cu under build/tune_radix_sort/ ("" is
the source as it is), builds it with ops/cuda/nvcc.py's flags (with
--ptxas, plus -Xptxas -v, whose report of registers, shared memory and
spills is printed), checks it exactly against the plain version on the
flagship's 16,646,144 K=24 keys with sentinels and on every adversarial
case of chip_smoke.py at 2**20 keys, and times it in turns with
torch.sort (median of 10 by CUDA events; torch.sort, variants..., variants
reversed, torch.sort) at 16,646,144, 5,046,272 and 65,536 keys. With
--profile, it then traces 5 sorts of the first variant at each size with
torch.profiler and prints the device time of each kernel and memset per
sort, the host wall time of a sort (synchronised) and the host time of the
wrapper's steps. Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from allpathslg_tpu_torch.ops.cuda import nvcc, sort_cuda  # noqa: E402


def build_variant(variant: str, ptxas: bool):
    """The bound library of radix_sort.cu with the variant's constants."""
    return sort_cuda.bind(ctypes.CDLL(str(
        nvcc.build_variant("radix_sort.cu", variant, ptxas))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=[""])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_radix_sort: no CUDA device")
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    libs = {v: build_variant(v, args.ptxas) for v in args.variants}

    def run_with(variant, fn):
        sort_cuda.library.lib = libs[variant]
        return fn()

    # the flagship's keys, as phase 3 of chip_smoke.py sorts them
    from allpathslg_tpu_torch.kmer import kmerize
    codes = smoke.flagship_codes(args.seed)
    canon, valid = kmerize.kmer_windows(torch.from_numpy(codes).cuda(),
                                        smoke.FLAGSHIP_K)
    flat, _ = kmerize.flatten_kmers(canon, valid, smoke.FLAGSHIP_K)
    flagship = (flat[0] << 32) | flat[1]
    inputs = [(flagship, 64, "flagship")]
    for case in smoke.SORT_CASES:
        u, bits, _ = smoke.adversarial_sort_keys(case, 1 << 20, args.seed)
        inputs.append((torch.from_numpy(u.view(np.int64)).cuda(), bits, case))
    for variant in args.variants:
        for keys, bits, what in inputs:
            err = run_with(variant, lambda: smoke.sort_err(
                sort_cuda.radix_sort(keys, bits),
                sort_cuda.radix_sort_plain(keys, bits)))
            smoke.check(err == 0, f"{variant}: kernel != plain on {what}")
        print(f"[check] {variant or 'source'}: == plain on the flagship keys and "
              f"{len(smoke.SORT_CASES)} adversarial cases", flush=True)

    sizes = (("16.6 M", flagship),
             ("5.05 M", smoke.batch_keys(65_536, 100, args.seed + 4)),
             ("65,536", flagship[:65_536].clone()))
    for label, keys in sizes:
        flipped = keys ^ (-(1 << 63))
        hist, n_ones = sort_cuda.digit_histogram_plain(keys, 64)
        passes = len(sort_cuda.plan_passes(hist, n_ones, keys.numel(), 64))

        def lib_ms():
            return smoke.median_ms(lambda: torch.sort(flipped, stable=True))

        order = list(args.variants) + list(reversed(args.variants))
        t_lib = [lib_ms()]
        t = {i: [] for i in args.variants}
        for variant in order:
            t[variant].append(run_with(variant, lambda: smoke.median_ms(
                lambda: sort_cuda.radix_sort(keys, 64))))
        t_lib.append(lib_ms())
        floor = smoke.sort_lsd_bytes(keys.numel(), passes) \
            / smoke.HBM_BYTES_PER_S * 1e3
        shown = "; ".join(f"{i or 'source'}: " +
                          " / ".join(f"{x:.3f}" for x in v)
                          for i, v in t.items())
        print(f"[time] {label} keys ({keys.numel()}), {passes} passes, LSD "
              f"floor {floor:.4f} ms: torch.sort {t_lib[0]:.3f} / "
              f"{t_lib[1]:.3f} ms; {shown} ms", flush=True)
        if args.profile:
            run_with(args.variants[0], lambda: profile(label, keys))
    return 0


def profile(label: str, keys: torch.Tensor, reps: int = 5):
    """Prints each CUDA kernel's and memset's device time per sort, and
    the synchronised host wall time of a sort."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    sort_cuda.radix_sort(keys, 64)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sort_cuda.radix_sort(keys, 64)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            sort_cuda.radix_sort(keys, 64)
        torch.cuda.synchronize()
    rows = []
    for ev in p.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / reps, ev.count / reps, ev.key))
    total = sum(r[0] for r in rows)
    print(f"[profile] {label}: host wall per sort {np.median(walls):.3f} ms "
          f"(median of {reps}); device {total / 1e3:.3f} ms per sort:",
          flush=True)
    for us, count, key in sorted(rows, reverse=True):
        print(f"[profile]   {us / 1e3:.4f} ms, {count:g} per sort: "
              f"{key[:90]}", flush=True)
    host_costs(label, keys)


def host_costs(label: str, keys: torch.Tensor, reps: int = 200):
    """Prints the host microseconds (median of reps) of the wrapper's
    steps."""
    lib = sort_cuda.library()
    n = keys.numel()
    stream = torch.cuda.current_stream().cuda_stream
    out = [torch.empty_like(keys), torch.empty(n, dtype=torch.int32,
                                               device=keys.device)] * 2
    shifts = (ctypes.c_int * 6)(16, 24, 32, 40, 48, 56)
    work = None

    def histogram():
        nonlocal work
        work = sort_cuda._start_histogram(lib, keys, 64, stream)
        return sort_cuda._read_histogram(lib, 64, stream)

    hist, n_ones = histogram()

    def passes():  # on the work buffer that histogram() zeroed
        lib.radix_sort_passes(
            keys.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), out[3].data_ptr(), work.data_ptr(), n, 64,
            shifts, 6, stream)

    def us(fn, before=None):
        times = []
        for _ in range(reps):
            if before is not None:
                before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return float(np.median(times))

    def sort_synced():
        sort_cuda.radix_sort(keys, 64)
        torch.cuda.synchronize()

    def device_scope():
        with torch.cuda.device(keys.device):
            pass

    steps = {
        "torch.empty_like(keys)": (lambda: torch.empty_like(keys), None),
        "torch.cuda.device scope": (device_scope, None),
        "current_stream().cuda_stream":
            (lambda: torch.cuda.current_stream().cuda_stream, None),
        "histogram kernel + read back, synchronised": (histogram, None),
        "plan_passes":
            (lambda: sort_cuda.plan_passes(hist, n_ones, n, 64), None),
        "radix_sort_passes call, 6 passes, not synchronised":
            (passes, histogram),
        "whole sort, synchronised": (sort_synced, None),
    }
    for what, (fn, before) in steps.items():
        print(f"[host] {label}: {us(fn, before):.1f} us  {what}", flush=True)


if __name__ == "__main__":
    sys.exit(main())

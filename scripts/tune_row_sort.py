#!/usr/bin/env python3
"""Build variants of the Hopper batched row sort and time them on the card.

    python3 scripts/tune_row_sort.py [--variants "" kItems=16
                                      src=build/old_row_sort.cu ...]
                                     [--ptxas] [--profile]

A variant is a comma-separated list of NAME=VALUE, each setting the
constant `constexpr int NAME` (kItems: 32-key chunks a warp ranks, a tile
being 256 x kItems keys; kPassBlocksPerSm; kLookBackWindow) in a copy of
allpathslg_tpu_torch/csrc/row_sort.cu ("" is the source as it is), or
`src=PATH`, another source (an older one saved from git under build/; a
source with the first design's C interface, count, scan and scatter
launches a pass, is driven by `legacy_row_sort`); each is built with
ops/cuda/nvcc.py's flags under build/tune_row_sort/ (with --ptxas, plus
-Xptxas -v, whose report is printed), checked exactly against
row_sort_plain on the flagship's K=24 tiles (127 x 131,072), random 2-word
slabs (127 x 196,723, 1 % all-ones), random 2-word K=96 tiles (55 x
131,072), 4,096 rows of 600 and an odd 3 x 12,345, and timed in turns with
torch.sort(dim=1) (median of 10 by CUDA events; torch.sort, variants...,
variants reversed, torch.sort) at the first three. With --profile, it
then traces 5 sorts of the first variant at each with torch.profiler and
prints the device time of each kernel and memset per sort and the
synchronised host wall of a sort. Needs one CUDA GPU and nvcc.
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
from allpathslg_tpu_torch.ops.cuda import (nvcc, row_sort_cuda,  # noqa: E402
                                           sort_cuda)


def bind_legacy(lib):
    """The first design's C interface (one histogram, then count, scan
    and scatter launches a pass over a scratch of per-tile counts)."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.row_sort_histogram.argtypes = [vp, i64, i64, i32, vp, vp]
    lib.row_sort_passes.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32,
                                    ctypes.POINTER(i32), i32, vp]
    lib.row_sort_scratch_words.argtypes = [i64, i64]
    lib.row_sort_scratch_words.restype = i64
    return lib


def legacy_row_sort(lib, keys: torch.Tensor, key_bits: int):
    """A sort through a library of the first design, as its wrapper ran
    it (the histogram read back by a blocking copy)."""
    rows, row_len = keys.shape
    dev = keys.device
    stream = torch.cuda.current_stream().cuda_stream
    hist = torch.empty(lib.row_sort_hist_words(), dtype=torch.int32,
                       device=dev)
    lib.row_sort_histogram(keys.data_ptr(), rows, row_len, key_bits,
                           hist.data_ptr(), stream)
    keys_a, keys_b = torch.empty_like(keys), torch.empty_like(keys)
    idx_a = torch.empty((rows, row_len), dtype=torch.int32, device=dev)
    idx_b = torch.empty_like(idx_a)
    scratch = torch.empty(lib.row_sort_scratch_words(rows, row_len),
                          dtype=torch.int32, device=dev)
    host = hist.cpu().numpy()
    digits = host[:-1].reshape(-1, 256)[: key_bits // 8]
    shifts = sort_cuda.plan_passes(digits, int(host[-1]), keys.numel(),
                                   key_bits)
    err = lib.row_sort_passes(
        keys.data_ptr(), keys_a.data_ptr(), idx_a.data_ptr(),
        keys_b.data_ptr(), idx_b.data_ptr(), scratch.data_ptr(), rows,
        row_len, key_bits, (ctypes.c_int * len(shifts))(*shifts),
        len(shifts), stream)
    smoke.check(err == 0, f"legacy row_sort_passes: CUDA error {err}")
    return (keys_a, idx_a) if len(shifts) % 2 else (keys_b, idx_b)


def build_variant(variant: str, ptxas: bool):
    """A function sorting (keys, key_bits) with the variant's library."""
    if variant.startswith("src="):
        text = (ROOT / variant[4:]).read_text()
        path = nvcc.build_variant("row_sort.cu", "", ptxas, text=text)
    else:
        path = nvcc.build_variant("row_sort.cu", variant, ptxas)
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "row_sort_scratch_words"):
        lib = bind_legacy(lib)
        return lambda keys, key_bits: legacy_row_sort(lib, keys, key_bits)
    lib = row_sort_cuda.bind(lib)

    def sort(keys, key_bits):
        row_sort_cuda.library.lib = lib
        return row_sort_cuda.row_sort(keys, key_bits)
    return sort


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=[""])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_row_sort: no CUDA device")
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    sorts = {v: build_variant(v, args.ptxas) for v in args.variants}

    from allpathslg_tpu_torch.kmer import count as kcount
    flat = kcount._kmer_flat(
        torch.from_numpy(smoke.flagship_codes(args.seed)).cuda(),
        smoke.FLAGSHIP_K)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    inputs = (("flagship K=24 tiles",
               ((flat[0] << 32) | flat[1]).reshape(127, 131_072)),
              ("random 2-word slabs",
               smoke.random_rows(127, 196_723, 64, gen)),
              ("random 2-word K=96 tiles",
               smoke.random_rows(55, 131_072, 64, gen)),
              ("4,096 rows of 600", smoke.random_rows(4096, 600, 64, gen)),
              ("odd 3 x 12,345", smoke.random_rows(3, 12_345, 64, gen)))
    for variant, sort in sorts.items():
        for what, keys in inputs:
            got = sort(keys, 64)
            want = row_sort_cuda.row_sort_plain(keys, 64)
            smoke.check(torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]),
                        f"{variant}: kernel != plain on {what}")
        print(f"[check] {variant or 'source'}: == plain on "
              f"{', '.join(w for w, _ in inputs)}", flush=True)

    for label, keys in inputs[:3]:
        flipped = keys ^ (-(1 << 63))

        def lib_ms():
            return smoke.median_ms(lambda: torch.sort(flipped, dim=1))

        order = list(args.variants) + list(reversed(args.variants))
        t_lib = [lib_ms()]
        t = {i: [] for i in args.variants}
        for variant in order:
            t[variant].append(smoke.median_ms(
                lambda: sorts[variant](keys, 64)))
        t_lib.append(lib_ms())
        bound = smoke.row_sort_bound_ms(keys.numel())
        shown = "; ".join(f"{i or 'source'}: " +
                          " / ".join(f"{x:.3f}" for x in v)
                          for i, v in t.items())
        print(f"[time] {label} {tuple(keys.shape)}, bound {bound:.4f} ms: "
              f"torch.sort(dim=1) {t_lib[0]:.3f} / {t_lib[1]:.3f} ms; "
              f"{shown} ms", flush=True)
        if args.profile:
            profile(label, keys, sorts[args.variants[0]])
    return 0


def profile(label: str, keys: torch.Tensor, sort, reps: int = 5):
    """Prints each CUDA kernel's and memset's device time per sort, and
    the synchronised host wall time of a sort."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    sort(keys, 64)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sort(keys, 64)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            sort(keys, 64)
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


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host time of the read packing behind every upload: the port's native
packer (dtypes/packed.pack_codes / pack_quals, native/pack_reads.cpp)
against the numpy packing it replaced, at the benchmark cells' shapes.

    python3 scripts/time_pack.py [--device cuda] [--reps 7] [--seed 22]

Shapes: 65,536 x 101 and 65,536 x 37 read batches (the EC batches and
path_reads; jump_ec's 2x37 mates) and 16,384 x 101 rows gathered by
index from a 262,144-read set, as fill.pairs gathers each mate. Quals
come two ways: the benchmark simulator's profile (38 falling to 20, +-3,
so more than 16 values: the raw fallback) and 16 binned values (the
4-bit palette). Every native result is checked bit for bit against the
numpy packing first. Prints, a shape, the median milliseconds of
--reps calls: numpy codes, native codes, numpy quals, native quals, and
with --device cuda the whole upload (packed.device_codes + device_quals,
synchronised), so packing and copy can be told apart. Imports neither
JAX nor the JAX package: the numpy bodies below are the reference's.
"""

from __future__ import annotations

import argparse
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from allpathslg_tpu_torch.dtypes import packed  # noqa: E402


def numpy_pack_codes(codes):
    """allpathslg_tpu/dtypes/packed.py pack_codes, as it is there."""
    codes = np.asarray(codes, np.uint8)
    n, L = codes.shape
    Wb = (L + 15) // 16
    Wn = (L + 31) // 32
    cp = np.zeros((n, Wb * 16), np.uint32)
    cp[:, :L] = codes & 3
    sh = (np.arange(Wb * 16, dtype=np.uint32) % 16) * 2
    words = np.bitwise_or.reduce(
        (cp << sh).reshape(n, Wb, 16), axis=2).astype(np.uint32)
    npad = np.zeros((n, Wn * 32), bool)
    npad[:, :L] = codes == 4
    shn = np.arange(Wn * 32, dtype=np.uint32) % 32
    nmask = np.bitwise_or.reduce(
        (npad.astype(np.uint32) << shn).reshape(n, Wn, 32), axis=2)
    return words, nmask, L


def numpy_pack_quals(quals):
    """allpathslg_tpu/dtypes/packed.py pack_quals, as it is there."""
    quals = np.asarray(quals, np.uint8)
    n, L = quals.shape
    palette = np.unique(quals)
    if len(palette) > 16:
        return None, quals, L
    pal16 = np.zeros(16, np.uint8)
    pal16[: len(palette)] = palette
    idx = np.searchsorted(palette, quals).astype(np.uint32)
    Wq = (L + 7) // 8
    ip = np.zeros((n, Wq * 8), np.uint32)
    ip[:, :L] = idx
    sh = (np.arange(Wq * 8, dtype=np.uint32) % 8) * 4
    nib = np.bitwise_or.reduce(
        (ip << sh).reshape(n, Wq, 8), axis=2).astype(np.uint32)
    return nib, pal16, L


def sim_quals(rng, n, L):
    """portbench/sim.py's quality profile."""
    pos = np.arange(L)
    prof = np.clip(38 - 18 * np.maximum(0, pos - L // 2) / max(1, L // 2),
                   2, 40)
    q = np.broadcast_to(prof, (n, L)).astype(np.uint8)
    return np.clip(q + rng.integers(-3, 4, q.shape), 2, 41).astype(np.uint8)


def median_ms(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def same(a, b):
    return all((x is None and y is None) or np.array_equal(x, y)
               for x, y in zip(a, b))


def host_name() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="also time the whole upload to this device")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=22)
    args = ap.parse_args(argv)
    sync = lambda: None  # noqa: E731
    if args.device is not None:
        import torch
        dev = torch.device(args.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise SystemExit("no card: --device cuda needs one")
            sync = torch.cuda.synchronize
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
    print(f"host: {host_name()}, {len(os.sched_getaffinity(0))} cores")
    rng = np.random.default_rng(args.seed)
    pool = rng.integers(0, 5, (262_144, 101)).astype(np.uint8)
    pool_q = sim_quals(rng, 262_144, 101)
    rows = rng.integers(0, len(pool), 16_384)
    shapes = []
    for n, L in ((65_536, 101), (65_536, 37)):
        shapes.append((f"{n} x {L}",
                       rng.integers(0, 5, (n, L)).astype(np.uint8),
                       sim_quals(rng, n, L)))
    shapes.append(("16384 x 101 gathered", pool[rows], pool_q[rows]))
    print("| shape | quals | numpy codes ms | native codes ms | numpy quals "
          "ms | native quals ms | upload ms |")
    print("|---|---|---|---|---|---|---|")
    binned = np.arange(2, 42, 2.5).astype(np.uint8)   # 16 values
    for name, codes, q_sim in shapes:
        for qname, quals in (("sim (> 16 values)", q_sim),
                             ("16 binned", binned[q_sim % 16])):
            assert same(packed.pack_codes(codes), numpy_pack_codes(codes))
            assert same(packed.pack_quals(quals), numpy_pack_quals(quals))
            t = [median_ms(lambda: numpy_pack_codes(codes), args.reps),
                 median_ms(lambda: packed.pack_codes(codes), args.reps),
                 median_ms(lambda: numpy_pack_quals(quals), args.reps),
                 median_ms(lambda: packed.pack_quals(quals), args.reps)]
            up = "not measured"
            if args.device is not None:
                def upload():
                    packed.device_codes(codes, dev)
                    packed.device_quals(quals, dev)
                    sync()
                upload()
                up = f"{median_ms(upload, args.reps):.2f}"
            print(f"| {name} | {qname} | " + " | ".join(
                f"{x:.2f}" for x in t) + f" | {up} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

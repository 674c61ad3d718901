#!/usr/bin/env python3
"""Host time of long-read flank anchoring, `find_gap_segments`, in one
package: the reference's per-base Python or the port's array version.

    JAX_PLATFORMS=cpu python3 scripts/time_anchoring.py --package reference
    python3 scripts/time_anchoring.py --package port

It imports only the named package. Inputs, from --seed: a random genome
of --genome-size with PacBio reads at --coverage (the simulator's
defaults: mean length 8,000, 12 % error) and --gaps gaps of 1,500 bp
spread along it, each with 500 bp flanks, as long_read_patch anchors
them. Prints the seconds: the port's read index, built once for all
gaps, and then a gap; and the segments found (the same in both
packages).
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("reference", "port"),
                    required=True)
    ap.add_argument("--genome-size", type=int, default=500_000)
    ap.add_argument("--coverage", type=float, default=5.0)
    ap.add_argument("--gaps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=28)
    args = ap.parse_args(argv)
    pkg = ("allpathslg_tpu" if args.package == "reference"
           else "allpathslg_tpu_torch")
    sim = importlib.import_module(f"{pkg}.eval.sim")
    alr = importlib.import_module(f"{pkg}.asm.longread")

    g = sim.random_genome(args.genome_size, seed=args.seed)
    reads, _, _ = sim.simulate_long_reads(g, coverage=args.coverage,
                                          seed=args.seed + 1)
    cfg = alr.LongReadConfig()
    t0 = time.perf_counter()
    index = (alr.LongReadIndex(reads, cfg.K) if args.package == "port"
             else None)
    t_index = time.perf_counter() - t0
    n_segs = []
    step = args.genome_size // (args.gaps + 1)
    for i in range(1, args.gaps + 1):
        at = i * step
        tail, head = g[at - cfg.flank:at], g[at + 1500:at + 1500 + cfg.flank]
        kw = {"index": index} if index is not None else {}
        n_segs.append(len(alr.find_gap_segments(reads, tail, head, cfg,
                                                **kw)))
    total = time.perf_counter() - t0
    per_gap = (total - t_index) / args.gaps
    print(f"{args.package}: genome {args.genome_size} bp, {len(reads)} "
          f"PacBio reads ({sum(len(r) for r in reads)} bp), {args.gaps} "
          f"gaps: {total:.2f} s = read index {t_index:.2f} s once + "
          f"{per_gap:.3f} s a gap; segments per gap {n_segs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""tests/test_ultra.py's done-criterion for Ultra + LongProto, in one
package, at any genome size.

    JAX_PLATFORMS=cpu python3 scripts/ultra_criterion.py --package reference
    JAX_PLATFORMS=cpu python3 scripts/ultra_criterion.py --package reference \
        --stable-sort --genome-size 200000
    python3 scripts/ultra_criterion.py --package port [--device cpu]

The test's inputs: a random genome of --genome-size (seed 13), 15x CLR
reads of mean 5 kb at 15 % error (seed 17), 3 rounds of Ultra, then
LongProto on 250 bp tiles of the corrected reads (chip_smoke.py's
kmer_set, clean_frac and tile_assembly). Prints Ultra's seconds and
events, the clean 24-mer fraction, the assembly's total, contig count and
longest contig, and the share of 100-mers covered, beside the test's
limits (clean > 0.70, a total within 0.7-1.5 x the genome, covered >
0.80). With --stable-sort the reference's friend sort (`lax.sort`) runs
stably, as the port's does; the port then gives the same numbers.
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
    ap.add_argument("--genome-size", type=int, default=60_000)
    ap.add_argument("--stable-sort", action="store_true",
                    help="the reference's friend sort made stable")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (the reference runs on JAX's)")
    args = ap.parse_args(argv)
    import chip_smoke

    pkg = ("allpathslg_tpu" if args.package == "reference"
           else "allpathslg_tpu_torch")
    sim = importlib.import_module(f"{pkg}.eval.sim")
    ultra = importlib.import_module(f"{pkg}.long.ultra")
    longproto = importlib.import_module(f"{pkg}.long.longproto")
    kw = {"device": args.device} if args.package == "port" else {}
    if args.stable_sort:
        from jax import lax

        orig = lax.sort
        lax.sort = lambda *a, **k: orig(*a, **{**k, "is_stable": True})

    G = args.genome_size
    g = sim.random_genome(G, seed=13)
    reads, _, _ = sim.simulate_long_reads(g, coverage=15, mean_len=5000,
                                          error_rate=0.15, seed=17)
    t0 = time.perf_counter()
    cor, metrics = ultra.correct_long_reads(
        reads, ultra.UltraConfig(rounds=3), **kw)
    ultra_s = time.perf_counter() - t0
    clean = chip_smoke.clean_frac(cor, chip_smoke.kmer_set(g, 24))
    n_tiles, lens, covered = chip_smoke.tile_assembly(
        g, cor, lambda codes: longproto.long_proto(
            codes, longproto.LongProtoConfig(min_kmer_count=3,
                                             correction_rounds=0),
            **kw).contigs.seqs)
    total = sum(lens)
    print(f"{args.package}{' (stable sort)' if args.stable_sort else ''}: "
          f"genome {G} bp, {len(reads)} reads; Ultra {ultra_s:.1f} s "
          f"{metrics}; clean 24-mers {clean:.4f} (> 0.70: {clean > 0.70}); "
          f"total {total} bp = {total / G:.3f} G in {len(lens)} contigs, "
          f"longest {lens[0] if lens else 0} (0.7-1.5 G: "
          f"{0.7 * G < total < 1.5 * G}); 100-mers covered {covered:.4f} "
          f"(> 0.80: {covered > 0.80}); {n_tiles} tiles")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""One sample's wall at each genome size of a benchmark cell's
configuration, to set the size a cell runs at (the largest step whose
sample fits a third of the window).

    python3 scripts/sweep_genome_size.py --workload saureus.assemble \
        --sizes 250000 300000 350000 --seed 7 [--sets 2] \
        [--set jump_min_prefix_len=40] [--device cuda] \
        [--out build/sweep.jsonl]

runs, in this process and through portbench's harness, the cell's
warm-up sample and then `--sets` samples (read sets 0, 1, ... of the
seed) at each size, each from an empty run dir, and judges each against
the cell's limits with portbench's plain reference. `--set KEY=VALUE`
overrides a key of the configuration's `pipeline` block. Prints one JSON
line a sample: the size, its wall, `correct` and the checked numbers,
and the jump library's path through the stages (pairs kept by jump_ec,
align_jumps' insert estimate, the scaffold N50 and the gaps closed).
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

JUMP_PATH = {"jump_ec": ("n_pairs_in", "n_pairs_kept", "n_duplicates"),
             "align_jumps": ("n_aligned", "insert_mean_est"),
             "make_scaffolds": ("n_scaffolds", "scaffold_n50"),
             "patch_gaps": ("n_gaps_closed",)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sizes", type=int, nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from portbench import harness
    from portbench import trace as ptrace

    _, _, cfg, traffic, limits = harness.load_cell(args.workload)
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg["pipeline"][k] = json.loads(v)
    acfg = harness.assembly_config(cfg)
    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tmp = Path(tempfile.mkdtemp(prefix="sweep_"))
    out = open(args.out, "a") if args.out else None
    try:
        if cuda:
            ptrace.load_kernels()
        warm = harness.make_read_set(cfg, args.seed, harness.WARM_UP_SET,
                                     traffic["warmup_genome_size"])
        harness.write_read_set(cfg, traffic, warm, tmp / "set")
        harness.run_sample(traffic, acfg, tmp / "set", tmp / "run",
                           args.device, sync)
        for size in args.sizes:
            for i in range(args.sets):
                rs = harness.make_read_set(cfg, args.seed, i, size)
                harness.write_read_set(cfg, traffic, rs, tmp / "set")
                rec = harness.run_sample(traffic, acfg, tmp / "set",
                                         tmp / "run", args.device, sync)
                rd = rec["rd"]
                t = time.perf_counter()
                got = harness.check_samples(
                    [{"set": 0, "out": harness.collect(
                        rd, traffic, np.random.default_rng(i))}], [rs])[0]
                correct, _ = harness.judge(got, limits)
                line = {"workload": args.workload, "size": size, "set": i,
                        "seed": args.seed, "pipeline": cfg["pipeline"],
                        "wall": round(rec["wall"], 3),
                        "ingest_s": rec["ingest_s"], "correct": correct,
                        "checks": got,
                        "check_s": round(time.perf_counter() - t, 3),
                        "stages": {s: round(r["elapsed_s"], 3) for s, r in
                                   rd.manifest["stages"].items()}}
                for stage, keys in JUMP_PATH.items():
                    m = rd.metrics(stage)
                    line.update({k: m.get(k) for k in keys})
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                shutil.rmtree(tmp / "run")
    finally:
        if out:
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

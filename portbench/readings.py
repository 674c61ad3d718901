#!/usr/bin/env python3
"""Card readings of the check's numbers at a cell's own size, from which
the limits of `limits/` are set: sound runs, the faults of `faults.py`
planted in each sound run's samples, jump_ec at the reference
ALLPATHS-LG's floor of 40, and the control (control.py's strain).

    python3 portbench/readings.py --seconds <s> --out <file> \
        <workload>:<kind>:<seed> [...]

kind: `sound` (which also judges each of `faults.JUMP_FAULTS` whose
library the cell holds), `floor40` or `control`. Each item is one
harness.run in this process; one JSON line an item goes to standard
output and is appended to --out. The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

KINDS = ("sound", "floor40", "control")


def reading(harness, faults, workload: str, kind: str, seed: int,
            seconds: float) -> dict:
    from portbench.control import CONTROL_SNP_RATE

    kept = {}
    check, acfg = harness.check_samples, harness.assembly_config

    def keep(samples, read_sets):
        kept.update(samples=samples, read_sets=read_sets)
        return check(samples, read_sets)

    def floor40(cfg):
        return acfg(dict(cfg, pipeline=dict(cfg["pipeline"],
                                            jump_min_prefix_len=40)))

    harness.check_samples = keep
    if kind == "floor40":
        harness.assembly_config = floor40
    try:
        t0 = time.perf_counter()
        res = harness.run(argparse.Namespace(
            workload=workload, seed=seed, seconds=seconds, trace=0),
            t0, snp_rate=CONTROL_SNP_RATE if kind == "control" else 0.0)
        run_s = time.perf_counter() - t0
    finally:
        harness.check_samples, harness.assembly_config = check, acfg
    line = {"workload": workload, "kind": kind, "seed": seed,
            "correct": res["correct"], "samples": res["attempted"],
            "checks": {k: v["value"] for k, v in res["checks"].items()},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "run_s": run_s}
    if kind == "sound":
        limits = harness.load_cell(workload)[4]
        line["faults"] = {}
        for name, (lib, _) in faults.JUMP_FAULTS.items():
            if kept["samples"][0]["out"].get("jumps", {}).get(lib) is None:
                continue
            numbers = harness.check_samples(
                faults.planted(kept["samples"], kept["read_sets"], name),
                kept["read_sets"])
            correct, shown = harness.judge(harness.worst(numbers), limits)
            line["faults"][name] = {
                "correct": correct,
                "checks": {k: v["value"] for k, v in shown.items()}}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("plan", nargs="+")
    args = ap.parse_args(argv)

    from portbench import faults, harness

    with open(args.out, "a") as out:
        for item in args.plan:
            workload, kind, seed = item.split(":")
            assert kind in KINDS, kind
            line = json.dumps(reading(harness, faults, workload, kind,
                                      int(seed), args.seconds))
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The control of `correct`: a cell run with reads sequenced from a strain
of each sample's genome (CONTROL_SNP_RATE of its bases changed), judged
against the genome itself. It breaks the configurations' guarantee that
the assembly's bases come from the sample's genome: an assembly at 99.7 %
base identity in place of an exact one. Every compared number that can
see it has to come out above its limit.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...]

Prints one result line a seed. The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

CONTROL_SNP_RATE = 0.003     # tests/test_assisted.py's related strain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from portbench import harness

    for seed in args.seeds:
        run = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        res = harness.run(run, time.perf_counter(),
                          snp_rate=CONTROL_SNP_RATE)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a benchmark cell's idle device time goes, by the program's spans.

    python3 scripts/span_idle.py --workload rsph.assemble --seeds 1 2 3 \
        [--seconds 51] [--out build/span_idle.jsonl]

runs the cell traced (portbench's harness.run with --trace 1, one run a
seed, in this process) on the card, and for each run prints its result
line and splits the device's idle stretches inside the samples' windows
by the innermost program span open then (allpathslg_tpu_torch/trace.py):
on each thread the innermost open span, and of those the deepest that is
not a stage span (`stage.*`) nor a DAG wait (`dag.wait`), named after its
ancestors below the stage ("unipaths.path_reads > upload"); failing
that, "<stage> only" or "dag.wait only"; with nothing open, "outside
spans".
Also the share of idle time inside some span below the stage level, the
longest idle stretches inside no such span, with the stages running, and
each sample's device busy seconds and number of spans, and the device
events named as a span (none, as spans make no profiler event). On a
program without spans it reports the busy time alone.
Each run's record is appended to --out as one JSON line.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BELOW = ("stage.", "dag.wait")


def depth(s) -> int:
    d = 0
    while s.parent is not None:
        s, d = s.parent, d + 1
    return d


def path(s) -> str:
    """The span's name after those of its ancestors below the stage."""
    names = []
    while s is not None and not s.name.startswith(BELOW):
        names.append(s.name)
        s = s.parent
    return " > ".join(reversed(names))


def label(open_spans) -> tuple:
    """(label, covered) of the spans open at one instant."""
    inner = {}
    for s in open_spans:           # the innermost open span of each thread
        cur = inner.get(s.thread)
        if cur is None or depth(s) > depth(cur):
            inner[s.thread] = s
    below = [s for s in inner.values() if not s.name.startswith(BELOW)]
    if below:
        return path(max(below, key=depth)), True
    if not inner:
        return "outside spans", False
    names = sorted(s.name for s in inner.values())
    return "+".join(names) + " only", False


def split_idle(tracer, spans) -> dict:
    from portbench import trace as ptrace

    idle = collections.Counter()
    uncovered = []
    edges = sorted({t for s in spans for t in (s.t0, s.t1)})
    total = covered = 0.0
    for t0, t1 in tracer._windows:
        inside = [s for s in spans if s.t1 > t0 and s.t0 < t1]
        for g0, g1 in ptrace.gaps(tracer.intervals, t0, t1):
            cuts = [g0, *(t for t in edges if g0 < t < g1), g1]
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                name, cov = label([s for s in inside if s.t0 <= mid < s.t1])
                idle[name] += b - a
                total += b - a
                if cov:
                    covered += b - a
                else:
                    uncovered.append((b - a, name, a - t0))
    uncovered.sort(reverse=True)
    return {"idle_s": total, "covered_pct": 100.0 * covered / total
            if total else None,
            "busy_s_by_sample": [ptrace.union_s(tracer.intervals, t0, t1)
                                 for t0, t1 in tracer._windows],
            "spans_by_sample": [sum(t0 <= s.t0 < t1 for s in spans)
                                for t0, t1 in tracer._windows],
            "span_named_device_events": sum(
                n in {s.name for s in spans} for _, _, n in tracer.intervals),
            "by_span": [[n, v] for n, v in idle.most_common(25)],
            "longest_uncovered": [[round(d, 4), n, round(at, 3)]
                                  for d, n, at in uncovered[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/span_idle.jsonl")
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench import trace as ptrace

    try:
        from allpathslg_tpu_torch import trace
        spans_of = trace.spans
    except ImportError:      # a program without spans: busy time only
        trace, spans_of = None, list

    made = []

    class Kept(ptrace.Tracer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    ptrace.Tracer = Kept
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        if trace:
            trace.clear()
        made.clear()
        run = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=1)
        res = harness.run(run, time.perf_counter(), device=args.device)
        tracer = made[0]
        spans = [s for s in spans_of()
                 if any(t0 <= s.t0 < t1 for t0, t1 in tracer._windows)]
        rec = {"workload": args.workload, "seed": seed, "result": res,
               "idle": split_idle(tracer, spans)}
        print(json.dumps(res), flush=True)
        idle = rec["idle"]
        print(f"[idle] {args.workload} seed {seed}: {idle['idle_s']:.2f} s "
              f"idle, {idle['covered_pct']:.1f} % inside a span below the "
              f"stage level", flush=True)
        for n, v in idle["by_span"]:
            print(f"[idle]   {n}: {v:.3f} s", flush=True)
        print(f"[idle]   longest uncovered (s, label, at s): "
              f"{idle['longest_uncovered']}", flush=True)
        print(f"[idle]   device busy s by sample "
              f"{[round(b, 3) for b in idle['busy_s_by_sample']]}; spans by "
              f"sample {idle['spans_by_sample']}; device events named as a "
              f"span {idle['span_named_device_events']}", flush=True)
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

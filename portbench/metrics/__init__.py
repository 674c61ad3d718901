"""Per-layer metric readers: metrics/<metric name>.py, each with
`read(ctx) -> float | None`. A reader that finds nothing to read returns
None, and the metric is left out of the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Context:
    samples: list        # the window's samples: wall, ingest_s, out.stages
    trace: object        # trace.Tracer of the traced run
    device_kind: str     # torch.cuda.get_device_name(0)


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(entries: list, ctx: Context) -> dict:
    return {m["name"]: reader(m["name"])(ctx) for m in entries}


def stage_mean_s(ctx: Context, stages) -> float | None:
    """Mean seconds a sample of `stages` (their manifest elapsed_s summed),
    over the samples that ran any of them."""
    per = [sum(s["out"]["stages"][n] for n in stages
               if n in s["out"]["stages"]) for s in ctx.samples
           if any(n in s["out"]["stages"] for n in stages)]
    return sum(per) / len(per) if per else None


def roofline(ctx: Context, kernel: str) -> float | None:
    from portbench import bounds, trace

    return trace.roofline_pct(ctx.trace, kernel, bounds.peaks(ctx.device_kind))

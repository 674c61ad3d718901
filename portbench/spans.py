"""Seconds a sample in the program's own spans (allpathslg_tpu_torch/
trace.py), for the span_s.* and dag_wait_s readers.

The program records spans only while a torch.profiler session is open,
which in a run of this benchmark is the traced samples' (trace.Tracer);
of those, a reader takes the spans that started inside a sample's window.
A program without spans (no allpathslg_tpu_torch.trace module, or none
of the names recorded) reads None.
"""

from __future__ import annotations


def window_spans(ctx, names) -> list:
    """The program's spans named in `names` that started in a traced
    sample's window."""
    try:
        from allpathslg_tpu_torch import trace
    except ImportError:
        return []
    windows = getattr(ctx.trace, "_windows", [])
    return [s for s in trace.spans() if s.name in names
            and any(t0 <= s.t0 < t1 for t0, t1 in windows)]


def span_s(ctx, *names) -> float | None:
    """The spans' seconds summed over calls and threads, over the number
    of samples (they may exceed a sample's wall under stage_workers=2, as
    the stage_s.* do), or None when none was recorded."""
    got = window_spans(ctx, names)
    if not got or not ctx.samples:
        return None
    return sum(s.t1 - s.t0 for s in got) / len(ctx.samples)

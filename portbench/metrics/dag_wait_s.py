"""Seconds a sample that run_full's stages wait, each from the end of its
last dependency to its start on a worker (the span dag.wait)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "dag.wait")

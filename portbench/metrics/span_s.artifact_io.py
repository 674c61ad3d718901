"""Seconds a sample in run-dir artifact writes and reads (the spans
artifact.save and artifact.load of RunDir; a mapped load counts its
open only)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "artifact.save", "artifact.load")

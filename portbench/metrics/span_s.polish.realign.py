"""Seconds a sample in the polish stage's re-placements of the reads
(the span polish.realign, one a call of Pipeline._align_arrays)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "polish.realign")

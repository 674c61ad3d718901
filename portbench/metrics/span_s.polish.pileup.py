"""Seconds a sample in the loops of asm/polish that consume
_pileup_segments (the span polish.pileup, one a pass)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "polish.pileup")

"""Seconds a sample in align_jumps' placement of the jump reads on the
contigs (the span jump.place, inside align.place)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "jump.place")

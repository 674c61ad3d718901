"""Seconds a sample in io/sam.read_sam (the span ingest.sam, one a SAM
file)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "ingest.sam")

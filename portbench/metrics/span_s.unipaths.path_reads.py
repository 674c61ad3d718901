"""Seconds a sample in graph/pathsdb.path_reads in the unipaths stage
(the span unipaths.path_reads)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "unipaths.path_reads")

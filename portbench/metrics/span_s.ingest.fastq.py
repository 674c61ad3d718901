"""Seconds a sample in io/native_fastq.read_fastq_arrays (the span
ingest.fastq, one a FASTQ file)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "ingest.fastq")

"""Seconds a sample in uploads of reads: host 2-bit packing and copies
to the device (the span upload: DeviceBatches.from_host,
packed.device_codes, packed.device_quals)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "upload")

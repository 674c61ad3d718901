"""Seconds a sample in jump_ec's trusted-prefix truncation and outie ->
innie flip, batch by batch on the device (the span jump_ec.truncate)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "jump_ec.truncate")

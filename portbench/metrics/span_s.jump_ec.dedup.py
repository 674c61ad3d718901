"""Seconds a sample in jump_ec's host duplicate-pair removal, a hash of
each mate's trusted prefix (the span jump_ec.dedup)."""

from portbench.spans import span_s


def read(ctx):
    return span_s(ctx, "jump_ec.dedup")

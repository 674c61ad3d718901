"""The banded_bp kernel's launches in the traced samples: their least time
(bounds.py, from each call's shape) over their device time by kernel
name, in %."""

from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "banded_bp")

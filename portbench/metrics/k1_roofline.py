"""k1_roofline.<cell>: K1 (``ops/scan.py`` ``selective_scan_proj``, the
scan's inference forward), percent of its roofline, from the device time of
the kernels launched inside the benchmark's ``portbench.K1`` spans."""

from portbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "K1")

"""k3_roofline.<cell>: K3 (``ops/scan.py`` ``selective_scan_proj_bwd``,
the scan's adjoint), percent of its roofline, from the device time of the
kernels launched inside the benchmark's ``portbench.K3`` spans."""

from portbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "K3")

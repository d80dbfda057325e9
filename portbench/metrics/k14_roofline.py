"""k14_roofline.<cell>: K14 (``ops/scan.py`` ``conv_silu_fused``, the
Mamba's causal conv + SiLU in each block), percent of its roofline: the
least time its traced calls could take (``counts/conv_silu.py``) over the
device time of the kernels launched inside the benchmark's
``portbench.K14`` spans. None where the window launched none (a program
without K14)."""

from portbench.counts.conv_silu import bound_s
from portbench.harness.readers import is_kernel


def read(ctx):
    trace = ctx["trace"]
    calls = trace.calls.get("K14", [])
    spent = sum(sec for name, sec, span in trace.kernels if span == "K14" and is_kernel(name))
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(bound_s(args, outs)[0] for args, outs in calls) / spent

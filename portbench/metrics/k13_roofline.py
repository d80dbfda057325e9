"""k13_roofline.<cell>: K13 (``ops/layer_norm.py`` ``layer_norm``, LFT's
LayerNorms with the position code's add folded in), percent of its
roofline: the least time its traced calls could take
(``counts/layer_norm.py``) over the device time of the kernels launched
inside the benchmark's ``portbench.K13`` spans. None where the window
launched none (a program without K13)."""

from portbench.counts.layer_norm import bound_s
from portbench.harness.readers import is_kernel


def read(ctx):
    trace = ctx["trace"]
    calls = trace.calls.get("K13", [])
    spent = sum(sec for name, sec, span in trace.kernels if span == "K13" and is_kernel(name))
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(bound_s(args, outs)[0] for args, outs in calls) / spent

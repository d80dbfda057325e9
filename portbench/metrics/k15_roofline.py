"""k15_roofline.<cell>: K15 (``ops/dense_attention.py`` ``dense_mha``,
LF-DET's attentions with no mask), percent of its roofline: the least time
its traced calls could take (``counts/dense_attention.py``) over the device
time of the kernels launched inside the benchmark's ``portbench.K15``
spans. None where the window launched none (a program without K15)."""

from portbench.counts.dense_attention import bound_s
from portbench.harness.readers import is_kernel


def read(ctx):
    trace = ctx["trace"]
    calls = trace.calls.get("K15", [])
    spent = sum(sec for name, sec, span in trace.kernels if span == "K15" and is_kernel(name))
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(bound_s(args, outs)[0] for args, outs in calls) / spent

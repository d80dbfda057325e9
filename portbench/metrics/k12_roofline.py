"""k12_roofline.<cell>: K12 (``ops/local_attention.py``
``local_window_mha``, LFT's banded spatial attention), percent of its
roofline: the least time its traced calls could take
(``counts/local_attention.py``) over the device time of the kernels
launched inside the benchmark's ``portbench.K12`` spans. None where the
window launched none (a program without K12)."""

from portbench.counts.local_attention import bound_s
from portbench.harness.readers import is_kernel


def read(ctx):
    trace = ctx["trace"]
    calls = trace.calls.get("K12", [])
    spent = sum(sec for name, sec, span in trace.kernels if span == "K12" and is_kernel(name))
    if not calls or spent <= 0:
        return None
    return 100.0 * sum(bound_s(args, outs)[0] for args, outs in calls) / spent

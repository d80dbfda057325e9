"""What the per-layer readers share: the trace's kernels per unit, a
kernel's roofline, the model's FLOPs per unit."""

from __future__ import annotations

from portbench.counts import kernels as kernel_counts

COPIES = ("Memcpy", "Memset")


def units(ctx) -> int:
    return sum(ctx["trace_units"].values())


def is_kernel(name: str) -> bool:
    return not name.startswith(COPIES)


def roofline(ctx, kid: str):
    """Percent of its roofline that kernel ``kid`` reached in the traced
    window: the least time its calls could take (``counts/kernels.py``, from
    their operands) over the device time of the kernels launched inside its
    spans. None where the window launched none of it."""
    trace = ctx["trace"]
    calls = trace.calls.get(kid, [])
    spent = sum(sec for name, sec, span in trace.kernels if span == kid and is_kernel(name))
    if not calls or spent <= 0:
        return None
    least = sum(kernel_counts.bound_s(kid, args, outs)[0] for args, outs in calls)
    return 100.0 * least / spent

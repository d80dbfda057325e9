"""What the readers of the program's own spans and counters share: the
summary of ``lfsr_tpu_torch.trace`` (which records only while the profiler
does, so it holds the traced sub-window alone), summed over span names and
divided by the sub-window's units. A program without that module has no
such spans: the readers then return None."""

from __future__ import annotations

from portbench.harness.readers import units


def summary() -> dict | None:
    try:
        from lfsr_tpu_torch import trace
    except ImportError:
        return None
    return trace.summary()


def span_ms(ctx, key: str, names) -> float | None:
    """Sum of ``key`` (``host_ms``, ``device_self_ms``, ...) over the spans
    whose names ``names`` accepts, per unit; None where no such span was
    recorded."""
    s = summary()
    if s is None:
        return None
    got = [v[key] for name, v in s["spans"].items() if names(name)]
    return sum(got) / units(ctx) if got else None


def counted(ctx, name: str) -> float | None:
    """Counter ``name`` recorded in the sub-window, per unit."""
    s = summary()
    return None if s is None else s["counts"].get(name, 0) / units(ctx)

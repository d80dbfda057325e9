"""Operations and bytes of one call of K14 (``ops/scan.py``
``conv_silu_fused``: the Mamba's causal depthwise conv1d over L, its bias
and SiLU), from its logical operands and the function it computes, never
from how the kernel computes it: xs read once (the [B, L, Di] the wrapper
is given, whatever wider rows it lies in), wconv and bconv once, the output
written once; per element, on the CUDA cores, K products, K - 1 adds and
the bias add, and SiLU's negation, exp, add and division: 2K + 4
operations.

The call is logged as the wrapper was called: (xs, wconv, bconv) ->
(xc,); an operand is anything with ``shape``, ``numel()`` and
``element_size()``.
"""

from __future__ import annotations

from portbench.counts.peaks import F32_FLOPS, HBM_BYTES_S


def work(args, outs) -> tuple[int, float, float]:
    """(bytes, matrix-product FLOPs, other FLOPs) of one K14 call."""
    xs, wconv, bconv = args[:3]
    nbytes = sum(t.numel() * t.element_size() for t in (xs, wconv, bconv, *outs))
    return nbytes, 0.0, float(xs.numel() * (2 * wconv.shape[0] + 4))


def bound_s(args, outs) -> tuple[float, str]:
    """The least time the card could take for the call, in seconds, and
    what sets it (``bytes`` or ``operations``)."""
    nbytes, _, other = work(args, outs)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, other / F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

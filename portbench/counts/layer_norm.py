"""Operations and bytes of one call of K13 (``ops/layer_norm.py``
``layer_norm``: a LayerNorm over the last axis with the add of a position
code folded in), from its logical operands and the function it computes,
never from how the kernel computes it: x read once, the addend once,
gamma and beta once, the output written once; per element, on the CUDA
cores, the addend's add (with one), sum(s) and sum(s s) (an add, a
multiply, an add), rsqrt(var + eps) gamma, s - mean, the product and
+ beta: 8 operations with an addend, 7 without (the per-row mean, variance
and rsqrt are left out).

The call is logged as the wrapper was called: (x, gamma, beta, add or None,
out_dtype) -> (out,); an operand is anything with ``shape``, ``numel()``
and ``element_size()``.
"""

from __future__ import annotations

from portbench.counts.peaks import F32_FLOPS, HBM_BYTES_S


def work(args, outs) -> tuple[int, float, float]:
    """(bytes, matrix-product FLOPs, other FLOPs) of one K13 call."""
    x, gamma, beta = args[:3]
    add = args[3] if len(args) > 3 and hasattr(args[3], "numel") else None
    tensors = (x, gamma, beta, *outs) + (() if add is None else (add,))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return nbytes, 0.0, float(x.numel() * (7 + (add is not None)))


def bound_s(args, outs) -> tuple[float, str]:
    """The least time the card could take for the call, in seconds, and
    what sets it (``bytes`` or ``operations``)."""
    nbytes, _, other = work(args, outs)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, other / F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

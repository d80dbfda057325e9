"""Operations and bytes of one call of K15 (``ops/dense_attention.py``
``dense_mha``: multi-head attention with no mask, queries and keys of their
own lengths), from its logical operands and the function it computes, never
from how the kernel computes it: q, k and v read once and o written once;
the products q . k and p . v, 2 hd FLOPs each for every (query, key, head)
(4 B Lq Lk D in all) at the tensor rate of the operands' dtype; one
exponential a (query, key, head) (B heads Lq Lk) on the CUDA cores.

The call is logged as the wrapper was called: (q, k, v, heads) -> (o,); an
operand is anything with ``shape``, ``numel()``, ``element_size()`` and a
``dtype`` whose ``str`` ends in its torch name.
"""

from __future__ import annotations

from portbench.counts.peaks import BF16_TENSOR_FLOPS, F32_FLOPS, HBM_BYTES_S, TF32_TENSOR_FLOPS


def work(args, outs) -> tuple[int, float, float]:
    """(bytes, matrix-product FLOPs, other FLOPs) of one K15 call."""
    q, k, v, heads = args[:4]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, *outs))
    B, Lq, D = q.shape
    Lk = k.shape[1]
    return nbytes, 4.0 * B * Lq * Lk * D, float(B * heads * Lq * Lk)


def bound_s(args, outs) -> tuple[float, str]:
    """The least time the card could take for the call, in seconds, and
    what sets it (``bytes`` or ``operations``)."""
    nbytes, mm, other = work(args, outs)
    peak = BF16_TENSOR_FLOPS if str(args[0].dtype).endswith("bfloat16") else TF32_TENSOR_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_S, mm / peak + other / F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

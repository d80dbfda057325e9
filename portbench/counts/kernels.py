"""Operations and bytes of one call of each of the port's kernels.

Computed from the call's logical operands and outputs (their shapes and
dtypes) and the function the kernel computes, never from how a kernel
computes it: every operand read once, every output written once; a fused
multiply-add counts 2, an exp or a compare 1. A later kernel that fuses or
replaces one computes the same function on the same operands, so its count
stays. Frozen from ``chip_smoke.work`` and ``chip_smoke.bound`` (PR 13).

An operand is anything with ``shape``, ``numel()``, ``element_size()`` and
a ``dtype`` whose ``str`` ends in its torch name (a tensor, or the
harness's ``Operand``); other arguments are given as they were passed.
"""

from __future__ import annotations

from portbench.counts.peaks import BF16_TENSOR_FLOPS, F32_FLOPS, HBM_BYTES_S, TF32_TENSOR_FLOPS


def _is_operand(t) -> bool:
    return hasattr(t, "numel") and hasattr(t, "element_size")


def _dtype(t) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


def work(name: str, args, outs) -> tuple[int, float, float]:
    """(bytes, matrix-product FLOPs, other FLOPs) of one call of kernel
    ``name`` ("K1" ... "K10") on ``args`` giving ``outs``."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs) if _is_operand(t))
    x = args[0]
    if name in ("K1", "K2", "K3"):  # per (b, t, channel): dt projection, softplus,
        # exp(delta A), state update and C.h for each of the N states
        wdt, A = (args[3], args[5]) if name == "K3" else (args[2], args[4])
        R, N = wdt.shape[0], A.shape[1]
        per = 2 * R + 6 + (21 if name == "K3" else 7) * N  # K3: recompute + adjoint
        return nbytes, 0.0, float(x.numel() * per)
    if name == "K9b":  # softplus, the scan as K1's, D skip and the silu(z) gate;
        # the out-projection's product
        N, Dout = args[2].shape[1], args[7].shape[1]
        return nbytes, 2.0 * x.numel() * Dout, float(x.numel() * (6 + 7 * N + 7))
    if name == "K9a":  # softplus (delta given before it), the scan, the D skip
        N = args[2].shape[1]
        return nbytes, 0.0, float(x.numel() * ((6 if args[7] else 0) + 7 * N + 2))
    if name == "K10":  # per pixel: the products C x Cz and Cz x 9 rr; lrelu per z,
        # the nine adds per output
        Cz, rr = args[2].shape[2], args[2].shape[3]
        P = x.numel() // x.shape[-1]
        return nbytes, 2.0 * P * Cz * (x.shape[-1] + 9 * rr), float(P * (2 * Cz + 9 * rr))
    if name == "K9c":  # conv + bias + SiLU, x_proj, dt projection + softplus, the
        # scan, D skip and the gate, all float32
        KC, J, R, N = args[2].shape[0], args[4].shape[1], args[5].shape[0], args[7].shape[1]
        return nbytes, 0.0, float(x.numel() * (2 * KC + 5 + 2 * J + 2 * R + 6 + 7 * N + 7))
    if name == "K4":  # LayerNorm
        return nbytes, 0.0, 8.0 * x.numel()
    if name == "K5":  # C x C mix + scaled residual
        x = args[1]
        return nbytes, 2.0 * x.numel() * x.shape[-1], 3.0 * x.numel()
    if name == "K6":  # LN, qkv, 64-token window attention (4 heads), out-proj
        C, T, heads = x.shape[-1], 64, 4
        P = x.numel() // C
        return nbytes, float(P * C * (8 * C + 4 * T)), float(P * (10 * C + 4 * heads * T))
    if name == "K7":  # LN, folded head 1x1, depthwise 3x3, mix, lrelu, residual
        C, c4 = x.shape[-1], args[3].shape[0]
        P = x.numel() // C
        return nbytes, 2.0 * P * C * C, float(P * (11 * C + 18 * (C - c4)))
    if name == "K8":  # q k^T and p v per head; mask add, max, exp, sum
        B, L, D = x.shape
        return nbytes, 4.0 * B * L * L * D, 4.0 * B * args[4] * L * L
    raise KeyError(name)


def bound_s(name: str, args, outs) -> tuple[float, str]:
    """The least time the card could take for the call, in seconds, and
    what sets it: the larger of its bytes over the HBM bandwidth and its
    operations over their peaks (products of bf16 operands at the bf16
    tensor-core rate, of float32 ones at the TF32 rate, the rest on the
    CUDA cores)."""
    nbytes, mm, other = work(name, args, outs)
    mm_dtype = _dtype(args[3] if name == "K7" else args[0])
    mm_peak = BF16_TENSOR_FLOPS if mm_dtype == "bfloat16" else TF32_TENSOR_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_S, mm / mm_peak + other / F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

"""LFVSSMBlock front: LayerNorm + MultiScaleLocal (K7's plain math).

The TPU fuses this front into the Pallas kernel ``pallas_block.ln_msl``
(K7) once a call carries at least ``LN_MSL_MIN_PIXELS`` pixels
(pallas_block.py:138-160). K7 is not ported yet (ROADMAP queue 2). Below
that gate the TPU runs the plain LayerNorm + MultiScaleLocal, and so does
the port; at or above it, the port raises on a CUDA tensor rather than
stand in for the kernel (:func:`require_below_ln_msl_gate`).

:func:`ln_msl_plain` is the port of ``ln_msl_ref`` — the twin K7 will be
held against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfsr_tpu_torch.ops.cross_scan import layer_norm_fast

LN_MSL_MIN_PIXELS = 4 * 160 * 160
K7_ROADMAP = "ROADMAP.md queue 2, K7 (pallas_block.ln_msl)"


def require_below_ln_msl_gate(x: torch.Tensor) -> None:
    """Raise where the TPU would run K7 and the port has no kernel for it."""
    b, h, w, _ = x.shape
    if x.device.type == "cuda" and b * h * w >= LN_MSL_MIN_PIXELS:
        raise NotImplementedError(
            f"LFVSSMBlock at {b}x{h}x{w} pixels reaches the fused LayerNorm + "
            f"MultiScaleLocal kernel's gate ({LN_MSL_MIN_PIXELS} pixels), which is "
            f"not ported to CUDA yet: {K7_ROADMAP}"
        )


def ln_msl_plain(x, gamma, beta, whm, wrest, wk, slope: float = 0.1):
    """Plain K7: returns (xn, local) with xn = LN(x) in x.dtype and
    local = lrelu(xn[..., :c4] @ whm + dw3x3(xn[..., c4:]) @ wrest) + xn.
    whm [c4, C]; wrest [C-c4, C]; wk [3, 3, C-c4]."""
    c4 = whm.shape[0]
    xn = layer_norm_fast(x, gamma, beta).to(x.dtype)
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(xn[..., c4:], (0, 0, 1, 1, 1, 1))
    rest = None
    for ky in range(3):
        for kx in range(3):
            term = xp[:, ky : ky + H, kx : kx + W, :] * wk[ky, kx]
            rest = term if rest is None else rest + term
    y = xn[..., :c4] @ whm + rest @ wrest
    y = torch.where(y >= 0, y, slope * y)
    return xn, y + xn

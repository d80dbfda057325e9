"""HLFR tail: expansion matmul + lrelu + folded 3x3 out-conv taps.

The TPU kernel ``pallas_head.hlfr_tail`` (K10) is retired on the TPU —
its ``_supported()`` is always False (pallas_head.py:90-103) — so the TPU
runs this plain chain, and so does the port. Port of ``hlfr_tail_ref``.
"""

from __future__ import annotations

import torch


def hlfr_tail_plain(y, w1, kf, bias, slope: float = 0.1):
    """y [B, S, S, C] (compute dtype); w1 [C, Cz]; kf [3, 3, Cz, rr];
    bias [1]. Returns [B, S, S, rr] float32."""
    from lfsr_tpu_torch.models.lfmambax import apply_folded_taps

    dt = y.dtype
    z = y @ w1.to(dt)
    z = torch.where(z >= 0, z, slope * z)
    return apply_folded_taps(z.to(dt), kf.to(dt), bias)

"""Bicubic resize for the model's global residual.

Port of ``lfsr_tpu.ops.resize.interpolate``, whose dense-plan JAX form is
pinned to ``F.interpolate(mode='bicubic', align_corners=False)`` by
tests/test_resize.py — so here it is that operator itself, in float32.
(The MATLAB-exact ``imresize`` used by offline data generation is not on
the eval path and is not ported.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate(x: torch.Tensor, scale_factor: int, method: str = "bicubic") -> torch.Tensor:
    """torch.nn.functional.interpolate(align_corners=False) on NCHW, f32."""
    if method != "bicubic":
        raise NotImplementedError(f"interpolate: only bicubic is ported, got {method!r}")
    return F.interpolate(
        x.float(), scale_factor=scale_factor, mode="bicubic", align_corners=False
    )

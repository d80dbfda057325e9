"""Bicubic global residual (port of ``lfsr_tpu.models.cnn_baselines.bicubic_up``;
the CNN baselines themselves are not ported yet)."""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops.resize import interpolate


def bicubic_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """torch-semantics bicubic upsample of an NHWC tensor, float32."""
    return interpolate(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)

"""Light-field layout transforms: SAI mosaic <-> MacPI <-> per-view 4D.

Port of lfsr_tpu/ops/layout.py (same conventions):
- SAI mosaic: ``[..., U*h, V*w]`` — a U x V grid of h x w views.
- MacPI: ``[..., h*U, w*V]`` — each spatial site holds a U x V macro-pixel.
- Views: ``[..., U, V, h, w]``.
All are reshapes/permutes; results may be non-contiguous views.
"""

from __future__ import annotations

import torch


def sai_to_views(x: torch.Tensor, ang: int) -> torch.Tensor:
    """[..., U*h, V*w] -> [..., U, V, h, w]."""
    *lead, H, W = x.shape
    x = x.reshape(*lead, ang, H // ang, ang, W // ang)
    return x.movedim(-3, -2)


def views_to_sai(x: torch.Tensor, ang: int | None = None) -> torch.Tensor:
    """[..., U, V, h, w] -> [..., U*h, V*w]."""
    *lead, U, V, h, w = x.shape
    return x.movedim(-2, -3).reshape(*lead, U * h, V * w)


def views_to_macpi(x: torch.Tensor) -> torch.Tensor:
    """[..., U, V, h, w] -> [..., h*U, w*V]."""
    *lead, U, V, h, w = x.shape
    n = len(lead)
    x = x.permute(*range(n), n + 2, n, n + 3, n + 1)  # [..., h, U, w, V]
    return x.reshape(*lead, h * U, w * V)


def macpi_to_views(x: torch.Tensor, ang: int) -> torch.Tensor:
    """[..., h*U, w*V] -> [..., U, V, h, w]."""
    *lead, H, W = x.shape
    n = len(lead)
    x = x.reshape(*lead, H // ang, ang, W // ang, ang)  # [..., h, U, w, V]
    return x.permute(*range(n), n + 1, n + 3, n, n + 2)


def sai_to_macpi(x: torch.Tensor, ang: int) -> torch.Tensor:
    """SAI mosaic -> macro-pixel image."""
    return views_to_macpi(sai_to_views(x, ang))


def macpi_to_sai(x: torch.Tensor, ang: int) -> torch.Tensor:
    """Macro-pixel image -> SAI mosaic."""
    return views_to_sai(macpi_to_views(x, ang))

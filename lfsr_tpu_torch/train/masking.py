"""Masked angular pre-training (port of lfsr_tpu/train/masking.py).

- View masking zeroes whole non-centre views of the LR SAI mosaic, the same
  views for the whole batch; each batch has a 50% chance of no masking.
- Strategies random / grid / corners / center set the priority order over
  the A x A views; the centre view is never masked.
- The progressive curriculum interpolates the ratio over the warm-up epochs.
- SRACM zeroes one random spatial mask at per-view resolution, the same at
  every view.

Each transform is a ``draw_*`` (random numbers from a ``torch.Generator``,
on its device, nothing read back to the host) and an ``apply_*`` (pure),
so a test can feed both frameworks the same masks. ``mask_views`` and
``sracm`` are draw + apply.
"""

from __future__ import annotations

import numpy as np
import torch

from lfsr_tpu_torch import trace


def progressive_ratio(epoch: int, start: float, end: float, warmup_epochs: int) -> float:
    t = min(1.0, epoch / max(1, warmup_epochs))
    return start + t * (end - start)


def num_masked_views(ang: int, ratio: float) -> int:
    return max(1, int(ang * ang * ratio))


def strategy_order(noise: torch.Tensor, ang: int, strategy: str) -> torch.Tensor:
    """Priority order over the A*A views given the tie-break noise [A*A]
    (uniform in [0, 1)); the centre view always last. Flat view indices."""
    center = (ang // 2) * ang + (ang // 2)
    n = ang * ang
    iu, iv = np.divmod(np.arange(n), ang)
    if strategy == "grid":
        pri = ((iu + iv) % 2 != 0).astype(np.float32) * 1e3
    elif strategy == "corners":
        corner = ((iu % (ang - 1)) == 0) & ((iv % (ang - 1)) == 0)
        pri = (~corner).astype(np.float32) * 1e3
    elif strategy == "center":
        pri = (np.abs(iu - ang // 2) + np.abs(iv - ang // 2)).astype(np.float32)
    else:  # random
        pri = np.zeros(n, np.float32)
    pri = trace.upload(pri, noise.device) + noise
    pri[center] = float("inf")
    trace.count("h2d_copies")  # the Python scalar goes up as a copy
    return torch.argsort(pri)


def draw_view_mask(gen: torch.Generator, ang: int, k: int, strategy: str = "random",
                   skip_prob: float = 0.5) -> torch.Tensor:
    """The keep mask [A, A] float32 (0 on the k masked views), all ones
    when this batch is skipped (probability ``skip_prob``)."""
    dev = gen.device
    order = strategy_order(torch.rand(ang * ang, generator=gen, device=dev), ang, strategy)
    apply = torch.rand((), generator=gen, device=dev) < 1.0 - skip_prob
    masked = torch.zeros(ang * ang, dtype=torch.bool, device=dev)
    masked[order[:k]] = True
    trace.count("h2d_copies")  # index_put_'s value: the Python scalar, copied up
    keep = (~masked).to(torch.float32).reshape(ang, ang)
    return torch.where(apply, keep, torch.ones_like(keep))


def apply_view_mask(lr_sai: torch.Tensor, keep: torch.Tensor, ang: int) -> torch.Tensor:
    """Zero the views where ``keep`` [A, A] is 0. lr_sai [B, A*h, A*w(, C)]."""
    b, H, W = lr_sai.shape[:3]
    h, w = H // ang, W // ang
    v = lr_sai.reshape(b, ang, h, ang, w, *lr_sai.shape[3:])
    k = keep.to(lr_sai.dtype).reshape(1, ang, 1, ang, 1, *([1] * (lr_sai.dim() - 3)))
    return (v * k).reshape(lr_sai.shape)


def mask_views(gen, lr_sai, ang: int, k: int, strategy: str = "random",
               skip_prob: float = 0.5):
    """Zero ``k`` whole views (same selection for the batch)."""
    return apply_view_mask(lr_sai, draw_view_mask(gen, ang, k, strategy, skip_prob), ang)


def draw_sracm(gen: torch.Generator, h: int, w: int, ratio: float) -> torch.Tensor:
    """SRACM keep mask [h, w] bool at per-view resolution (True = keep)."""
    return torch.rand((h, w), generator=gen, device=gen.device) >= ratio


def apply_sracm(lr_sai: torch.Tensor, keep: torch.Tensor, ang: int) -> torch.Tensor:
    """Multiply every view of lr_sai [B, A*h, A*w, C] by ``keep`` [h, w]."""
    tiled = keep.to(lr_sai.dtype).repeat(ang, ang)
    return lr_sai * tiled[None, :, :, None]


def sracm(gen, lr_sai, ang: int, ratio: float):
    """Spatially-Random Angularly-Consistent Masking."""
    h, w = lr_sai.shape[1] // ang, lr_sai.shape[2] // ang
    return apply_sracm(lr_sai, draw_sracm(gen, h, w, ratio), ang)

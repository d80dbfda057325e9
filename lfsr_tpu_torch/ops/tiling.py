"""Overlap tiling for tiled evaluation.

Port of lfsr_tpu/ops/tiling.py (``tile_counts``, ``lf_divide``,
``lf_integrate``). ``lf_divide``'s mirror extension is whole-sample
symmetric padding — numpy's ``mode='symmetric'``, which repeats the edge
sample, not torch's ``reflect`` — built here as a static numpy index map
and applied with one gather per axis. EPSW Gaussian stitching
(``lf_integrate_gaussian``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from lfsr_tpu_torch.ops.layout import sai_to_views, views_to_sai


def tile_counts(h0: int, w0: int, patch: int, stride: int) -> tuple[int, int]:
    """Patch-grid shape for an h0 x w0 per-view image."""
    bdr = (patch - stride) // 2
    return (h0 + bdr * 2 - 1) // stride, (w0 + bdr * 2 - 1) // stride


def symmetric_index(size: int, before: int, after: int) -> np.ndarray:
    """Source indices of an axis of ``size`` samples extended by ``before``
    and ``after`` samples with numpy's ``mode='symmetric'``."""
    return np.pad(np.arange(size), (before, after), mode="symmetric")


def _patch_index(n: int, size: int, patch: int, stride: int) -> torch.Tensor:
    """[n*patch] source rows of the symmetric-extended patch grid."""
    bdr = (patch - stride) // 2
    ext = symmetric_index(size, bdr, bdr + stride - 1)
    idx = (np.arange(n) * stride)[:, None] + np.arange(patch)[None, :]
    return torch.from_numpy(ext[idx.reshape(-1)])


def lf_divide(sai: torch.Tensor, ang: int, patch: int, stride: int) -> torch.Tensor:
    """Split an SAI mosaic ``[U*h0, V*w0]`` into overlapping SAI patches
    ``[n1*n2, ang*patch, ang*patch]``."""
    views = sai_to_views(sai, ang)  # [U, V, h0, w0]
    h0, w0 = views.shape[-2], views.shape[-1]
    n1, n2 = tile_counts(h0, w0, patch, stride)
    hi = _patch_index(n1, h0, patch, stride).to(sai.device)
    wi = _patch_index(n2, w0, patch, stride).to(sai.device)
    x = views.index_select(-2, hi).index_select(-1, wi)
    x = x.reshape(ang, ang, n1, patch, n2, patch)
    x = x.permute(2, 4, 0, 1, 3, 5)  # [n1, n2, U, V, p, p]
    return views_to_sai(x, ang).reshape(n1 * n2, ang * patch, ang * patch)


def lf_integrate(patches: torch.Tensor, ang: int, patch: int, stride: int,
                 h: int, w: int) -> torch.Tensor:
    """Stitch SR patches ``[n1*n2, U*p, V*p]`` into views ``[U, V, h, w]`` by
    center crop. ``patch``/``stride`` are in output pixels."""
    bdr = (patch - stride) // 2
    n1 = (h + bdr * 2 - 1) // stride
    n2 = (w + bdr * 2 - 1) // stride
    if n1 * n2 != patches.shape[0]:
        raise ValueError(f"patch count {patches.shape[0]} != grid {n1}x{n2}")
    x = patches.reshape(n1, n2, ang, patch, ang, patch).movedim(-2, 3)
    x = x[..., bdr : bdr + stride, bdr : bdr + stride]  # [n1, n2, U, V, s, s]
    x = x.permute(2, 3, 0, 4, 1, 5).reshape(ang, ang, n1 * stride, n2 * stride)
    return x[..., :h, :w]

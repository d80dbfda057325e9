"""Light-field layout transforms: SAI mosaic <-> MacPI <-> per-view 4D.

Port of lfsr_tpu/ops/layout.py (same conventions):
- SAI mosaic: ``[..., U*h, V*w]`` — a U x V grid of h x w views.
- MacPI: ``[..., h*U, w*V]`` — each spatial site holds a U x V macro-pixel.
- Views: ``[..., U, V, h, w]``.
All are reshapes/permutes; results may be non-contiguous views.

LF-DET's angular branches cut a MacPI map into ws x ws windows and put
them back (:func:`macpi_windows`, :func:`windows_average`): a reshape of
the tiling where ws divides the map, else one gather and one scatter-add
over index tables made once per geometry on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lfsr_tpu_torch import trace


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


# ---------------------------------------------------------------------------
# MacPI windows (LF-DET's angular branches)
# ---------------------------------------------------------------------------

def window_starts(extent: int, ws: int) -> list[int]:
    """Starts of the ws-wide windows along an axis of ``extent``: every ws,
    and one more ending at the edge where ws does not divide it (the JAX
    ``_window_starts``)."""
    starts = list(range(0, extent - ws + 1, ws))
    if starts[-1] + ws < extent:
        starts.append(extent - ws)
    return starts


def divides(H: int, W: int, ws: int) -> bool:
    """The windows tile the map exactly (no window added at an edge)."""
    return H % ws == 0 and W % ws == 0


@functools.lru_cache(maxsize=64)
def _window_index(H: int, W: int, ws: int, device: torch.device):
    """(rows, cols, flat, count) of the edge-covered windows of an H x W map,
    on ``device``, once per geometry: each window's ws*ws pixels in
    row-major order, the windows row-major by their starts ([nW*ws*ws] row
    and column indices, and their flat index y*W + x), and the number of
    windows covering each pixel ([H*W, 1] float32)."""
    ys, xs = np.asarray(window_starts(H, ws)), np.asarray(window_starts(W, ws))
    off = np.arange(ws)
    rows = (ys[:, None, None, None] + off[None, None, :, None]) + 0 * xs[None, :, None, None]
    cols = (xs[None, :, None, None] + off[None, None, None, :]) + 0 * ys[:, None, None, None]
    rows, cols = np.broadcast_arrays(rows, cols)
    flat = (rows * W + cols).reshape(-1)
    with torch.inference_mode(False):
        rows_t = trace.upload(rows.reshape(-1).astype(np.int64), device)
        cols_t = trace.upload(cols.reshape(-1).astype(np.int64), device)
        flat_t = trace.upload(flat.astype(np.int64), device)
        count = torch.zeros(H * W, 1, device=device).index_add_(
            0, flat_t, torch.ones(flat_t.numel(), 1, device=device))
    return rows_t, cols_t, flat_t, count


def window_count(H: int, W: int, ws: int) -> tuple[int, int]:
    """(windows, of them added at an edge) of an H x W map."""
    nh, nw = len(window_starts(H, ws)), len(window_starts(W, ws))
    return nh * nw, nh * nw - (H // ws) * (W // ws)


def macpi_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """The ws x ws windows of a MacPI map x [B, H, W, C] (any strides) as
    tokens [B*nW, ws*ws, C], windows row-major by their starts
    (:func:`window_starts`), each window's pixels row-major: one copy where
    ws divides H and W (a reshape of the tiling), else one gather, the
    windows at the edges overlapping their neighbours."""
    B, H, W, C = x.shape
    if divides(H, W, ws):
        t = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(-1, ws * ws, C)
    rows, cols, _, _ = _window_index(H, W, ws, x.device)
    return x[:, rows, cols].reshape(-1, ws * ws, C)


def windows_average(toks: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`macpi_windows`: tokens [B*nW, ws*ws, C] back to
    a map [B, H, W, C] of their dtype, where windows overlap the mean of
    their tokens (summed in float32, divided by the count, rounded once: the
    JAX branch's overlap average); the tiling's reshape where ws divides H
    and W. The edge path is one scatter-add and one division, whatever the
    number of windows."""
    C = toks.shape[-1]
    if divides(H, W, ws):
        t = toks.reshape(-1, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(-1, H, W, C)
    _, _, flat, count = _window_index(H, W, ws, toks.device)
    src = toks.reshape(-1, flat.numel(), C)
    out = torch.zeros(src.shape[0], H * W, C, dtype=torch.float32, device=toks.device)
    out.index_add_(1, flat, src.float())
    return (out / count).to(toks.dtype).reshape(-1, H, W, C)

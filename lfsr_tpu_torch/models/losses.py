"""Training losses (port of lfsr_tpu/models/losses.py:23-168).

All are ``(sr, hr) -> scalar`` on NHWC SAI mosaics [B, A*h, A*w, 1] and
compute in float32 whatever dtype the model ran in. Filters are written as
shifted adds (no convolution call, so no TF32 on the card), as the JAX
module writes them. Ported: the terms of the flagship's ``composite_v8``
and its builder; the other builders wait until a model that uses them is
ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.ops.layout import sai_to_views


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def l1(sr, hr):
    return (_f32(sr) - _f32(hr)).abs().mean()


def charbonnier(sr, hr, eps: float = 1e-9):
    d = _f32(sr) - _f32(hr)
    return torch.sqrt(d * d + eps * eps).mean()


def fft_magnitude_l1(sr, hr):
    """L1 between rfft2 magnitudes over the spatial axes (1, 2)."""
    fs = torch.fft.rfft2(_f32(sr), dim=(1, 2)).abs()
    fh = torch.fft.rfft2(_f32(hr), dim=(1, 2)).abs()
    return (fs - fh).abs().mean()


def _box_blur(a, window: int):
    """Uniform window x window mean filter with 'same' zero padding, as two
    separable shift-add passes (over axes 1 and 2)."""
    p = window // 2

    def pass_along(x, axis):
        n = x.shape[axis]
        pad = [0, 0] * (x.dim() - axis - 1) + [p, p]
        xp = F.pad(x, pad)
        acc = xp.narrow(axis, 0, n)
        for k in range(1, window):
            acc = acc + xp.narrow(axis, k, n)
        return acc

    return pass_along(pass_along(a, 1), 2) / (window * window)


def ssim_loss(sr, hr, window: int = 7):
    """1 - SSIM with a uniform window and the variance clamp."""
    x, y = _f32(sr), _f32(hr)
    c1, c2 = 0.01**2, 0.03**2

    def blur(a):
        return _box_blur(a, window)

    mx, my = blur(x), blur(y)
    vx = torch.clamp_min(blur(x * x) - mx * mx, 0)
    vy = torch.clamp_min(blur(y * y) - my * my, 0)
    vxy = blur(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * vxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return 1.0 - s.mean()


def _shift(x, axis: int, d: int):
    """x shifted by d along axis with zero fill (out[i] = x[i - d])."""
    n = x.shape[axis]
    pad = [0, 0] * (x.dim() - axis - 1) + [max(d, 0), max(-d, 0)]
    return F.pad(x, pad).narrow(axis, max(-d, 0), n)


def _sobel_x(a):
    """Sobel-x = [1, 2, 1]^T (x) [-1, 0, 1] as separable shift-adds."""
    a = _f32(a)
    s = _shift(a, 1, 1) + 2.0 * a + _shift(a, 1, -1)  # smooth along H
    return _shift(s, 2, -1) - _shift(s, 2, 1)          # diff along W


def _sobel_y(a):
    a = _f32(a)
    s = _shift(a, 2, 1) + 2.0 * a + _shift(a, 2, -1)
    return _shift(s, 1, -1) - _shift(s, 1, 1)


def gradient_l1(sr, hr):
    """L1 over Sobel-x and Sobel-y responses."""
    return ((_sobel_x(sr) - _sobel_x(hr)).abs().mean()
            + (_sobel_y(sr) - _sobel_y(hr)).abs().mean())


def angular_consistency(sr, hr, ang: int):
    """L1 on adjacent-view parallax differences in both angular axes."""
    sv = sai_to_views(_f32(sr[..., 0]), ang)  # [B, U, V, h, w]
    hv = sai_to_views(_f32(hr[..., 0]), ang)
    lu = (torch.diff(sv, dim=1) - torch.diff(hv, dim=1)).abs().mean()
    lv = (torch.diff(sv, dim=2) - torch.diff(hv, dim=2)).abs().mean()
    return lu + lv


def composite_v8_builder(cfg: Config):
    """Charbonnier + 0.1 FFT + 0.02 SSIM + 0.04 gradient + 0.06 angular
    (weights overridable through ``cfg.model_kwargs``, as in JAX)."""
    eps = cfg.mk("charbonnier_eps", 1e-9)
    wf = cfg.mk("fft_weight", 0.1)
    ws = cfg.mk("ssim_weight", 0.02)
    wg = cfg.mk("grad_weight", 0.04)
    wa = cfg.mk("angular_weight", 0.06)
    ang = cfg.angRes

    def loss(sr, hr):
        out = charbonnier(sr, hr, eps)
        out = out + wf * fft_magnitude_l1(sr, hr)
        out = out + ws * ssim_loss(sr, hr)
        out = out + wg * gradient_l1(sr, hr)
        if sr.shape[1] % ang == 0 and sr.shape[2] % ang == 0:
            out = out + wa * angular_consistency(sr, hr, ang)
        return out

    return loss

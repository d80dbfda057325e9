"""PSNR and SSIM with skimage semantics (port of lfsr_tpu/ops/metrics.py).

Per-view Y-channel PSNR (data_range=1) and SSIM with an 11-tap separable
Gaussian window (sigma 1.5, sample covariance), VALID, averaged over the
U x V views. The filter is written as shifted multiply-adds in float32 —
no convolution library call, so no TF32 on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lfsr_tpu_torch.ops.layout import sai_to_views

_SIGMA = 1.5
_TRUNCATE = 3.5
_RADIUS = int(_TRUNCATE * _SIGMA + 0.5)  # 5 -> 11 taps
_WIN = 2 * _RADIUS + 1


@functools.lru_cache(maxsize=1)
def _gauss_taps() -> tuple[float, ...]:
    x = np.arange(-_RADIUS, _RADIUS + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / _SIGMA) ** 2)
    return tuple(np.float32(k / k.sum()).tolist())


def _filter_valid(x: torch.Tensor) -> torch.Tensor:
    """Separable VALID Gaussian filter over the trailing two axes."""
    taps = _gauss_taps()
    h, w = x.shape[-2:]
    ho, wo = h - _WIN + 1, w - _WIN + 1
    y = sum(t * x[..., i : i + ho, :] for i, t in enumerate(taps))
    return sum(t * y[..., :, i : i + wo] for i, t in enumerate(taps))


def psnr(ref: torch.Tensor, test: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    err = ((ref.float() - test.float()) ** 2).mean(dim=(-2, -1))
    return 10.0 * torch.log10(data_range**2 / err)


def ssim(ref: torch.Tensor, test: torch.Tensor, data_range: float = 1.0,
         use_sample_covariance: bool = True) -> torch.Tensor:
    x = ref.float()
    y = test.float()
    taps = _WIN * _WIN
    cov_norm = taps / (taps - 1.0) if use_sample_covariance else 1.0
    ux, uy = _filter_valid(x), _filter_valid(y)
    uxx, uyy, uxy = _filter_valid(x * x), _filter_valid(y * y), _filter_valid(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(-2, -1))


def lf_metrics(label_sai: torch.Tensor, out_sai: torch.Tensor, ang: int):
    """Per-view PSNR/SSIM averaged over views (and any leading dims)."""
    lv = sai_to_views(label_sai, ang)
    ov = sai_to_views(out_sai, ang)
    return psnr(lv, ov).mean(), ssim(lv, ov).mean()

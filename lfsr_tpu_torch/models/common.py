"""Shared building blocks (port of lfsr_tpu/models/common.py).

Activations are NHWC, as in the JAX package. Parameters are float32 and
stored in PyTorch's layouts (conv weight [O, I/groups, kh, kw]); every
module computes in its ``dtype`` (the config's compute dtype), casting
inputs and weights to it exactly where flax's ``dtype=`` does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lfsr_tpu_torch.ops.depthwise import check_conv as check_depthwise, depthwise_conv


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """flax leaky_relu: where(x >= 0, x, slope * x)."""
    return torch.where(x >= 0, x, slope * x)


class Conv(nn.Module):
    """flax ``nn.Conv`` with torch Conv2d-style integer padding, NHWC in and
    out, computed in ``dtype``; the bias is added after the convolution in
    ``dtype``, as flax does. 1x1 convs run as matmuls (same map). A
    depthwise conv (groups = c_in = c_out > 1) runs as K11 in its
    ``"once"`` rounding, the conv's own; one K11 does not take
    (``ops.depthwise.check_conv``) is refused when it is built."""

    def __init__(self, c_in: int, c_out: int, kernel=3, dilation=1, padding=0,
                 groups: int = 1, bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        kh, kw = _pair(kernel)
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups, kh, kw, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device)) if bias else None
        self.dilation = _pair(dilation)
        self.padding = _pair(padding)
        self.groups = groups
        self.dtype = dtype
        self.depthwise = 1 < groups == c_in == c_out
        if self.depthwise:
            check_depthwise(c_out, (kh, kw), self.dilation, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.weight.shape[-2:] == (1, 1) and self.groups == 1:
            y = x.to(dt) @ mix_kernel(self, dt)
        elif self.depthwise:
            return depthwise_conv(x.to(dt), self.weight, self.dilation, "once", self.bias)
        else:
            y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), None,
                         padding=self.padding, dilation=self.dilation,
                         groups=self.groups).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class LayerNorm(nn.Module):
    """Parameter holder for a LayerNorm over the last axis (flax scale ->
    ``weight``); the math lives in the ops that use it."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))


def mix_kernel(conv: Conv, dt) -> torch.Tensor:
    """A 1x1 conv's weight as a [C_in, C_out] matrix in ``dt``."""
    return conv.weight[:, :, 0, 0].t().to(dt)


def pw_apply(conv: Conv, x: torch.Tensor, dt) -> torch.Tensor:
    """1x1 conv as a matmul (+bias), in ``dt``."""
    y = x.to(dt) @ mix_kernel(conv, dt)
    if conv.bias is not None:
        y = y + conv.bias.to(dt)
    return y


def dw_apply(conv: Conv, x: torch.Tensor, dt) -> torch.Tensor:
    """Depthwise KxK conv (zero 'same' padding, the conv's dilation) as
    shift-multiply-adds in ``dt``, taps accumulated in (ky, kx) order — the
    JAX ``_dw_apply`` form, rounding included: K11 in its ``"tap"``
    rounding (``ops.depthwise``)."""
    return depthwise_conv(x.to(dt), conv.weight, conv.dilation, "tap")


def dense(lin: nn.Linear, x: torch.Tensor, dt) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dt)``: x and the kernel cast to dt, the bias
    (where the layer has one) cast to dt and added after the product."""
    y = x.to(dt) @ lin.weight.t().to(dt)
    return y if lin.bias is None else y + lin.bias.to(dt)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch nn.PixelShuffle on NHWC: [B, H, W, C*r*r] -> [B, H*r, W*r, C]
    (output channel c reads input channel c*r*r + i*r + j)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)

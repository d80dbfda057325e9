"""Mamba block (port of lfsr_tpu/models/ssm.py), following the TPU split:

  in_proj (D -> 2*Di) -> [x | z]
  x: causal depthwise conv1d (width d_conv) + SiLU, as shifted multiply-adds
     x_proj (Di -> R + 2N) -> dbc
  K1 (ops/scan.selective_scan_proj): dt projection + softplus + scan + D skip
  y = scan * silu(z) in float32 -> out_proj (Di -> D)

On CPU tensors K1 runs its plain twin; the JAX oracle for this module is
``pallas_scan.mamba_inner_ref`` (the same math in float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from lfsr_tpu_torch.ops.scan import selective_scan_proj


def conv_silu(xs: torch.Tensor, w_conv: torch.Tensor, b_conv: torch.Tensor, dt) -> torch.Tensor:
    """Causal depthwise conv1d + SiLU over L. xs [B, L, Di];
    w_conv [Di, 1, K] (torch Conv1d layout); the K taps are accumulated in
    order in ``dt``, then the bias, as the JAX ``_conv_silu``."""
    K = w_conv.shape[-1]
    L = xs.shape[1]
    xp = F.pad(xs.to(dt), (0, 0, K - 1, 0))
    w = w_conv[:, 0, :].t().to(dt)  # [K, Di]
    acc = xp[:, 0:L] * w[0]
    for k in range(1, K):
        acc = acc + xp[:, k : k + L] * w[k]
    return F.silu(b_conv.to(dt) + acc)


class Mamba(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: float = 2.0, dt_rank: int | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        D = d_model
        Di = int(expand * D)
        N = d_state
        R = dt_rank or math.ceil(D / 16)
        self.dtype = dtype
        self.in_proj = nn.Linear(D, 2 * Di, bias=False, device=device)
        self.conv1d = nn.Conv1d(Di, Di, d_conv, groups=Di, bias=True, device=device)
        self.x_proj = nn.Linear(Di, R + 2 * N, bias=False, device=device)
        self.dt_proj = nn.Linear(R, Di, bias=True, device=device)
        self.A_log = nn.Parameter(torch.empty(Di, N, device=device))
        self.D = nn.Parameter(torch.empty(Di, device=device))
        self.out_proj = nn.Linear(Di, D, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, D] -> [B, L, D] in the compute dtype."""
        dt = self.dtype
        xz = x.to(dt) @ self.in_proj.weight.t().to(dt)
        xs, z = xz.chunk(2, dim=-1)
        xc = conv_silu(xs, self.conv1d.weight, self.conv1d.bias, dt)
        dbc = xc @ self.x_proj.weight.t().to(dt)
        A = -torch.exp(self.A_log)
        y = selective_scan_proj(xc, dbc, self.dt_proj.weight.t().contiguous(),
                                self.dt_proj.bias, A, self.D)
        y = y.float() * F.silu(z.float())
        return y.to(dt) @ self.out_proj.weight.t().to(dt)

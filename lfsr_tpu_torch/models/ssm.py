"""Mamba block (port of lfsr_tpu/models/ssm.py), following the TPU branches:

  in_proj (D -> 2*Di) -> [x | z]
  'pallas' (default): causal depthwise conv1d + SiLU as shifted multiply-adds,
     x_proj (Di -> R + 2N) -> dbc, K1 (dt projection + softplus + scan +
     D skip), y = scan * silu(z) in float32 -> out_proj (Di -> D)
  'gated': the same conv and x_proj, dt_raw = dbc[..., :R] @ Wdt + bdt in the
     compute dtype, then K9b (scan + D skip + silu(z) gate + out_proj), whose
     output is the block's
  'fused': K9c (conv + SiLU + x_proj + dt projection + scan + D skip + gate,
     float32 inside) -> out_proj
  'assoc': the plain reference of the whole inner pipeline,
     ``mamba_inner_plain`` (JAX's ``mamba_inner_ref``, float32 inside, its
     scan chunked at the flagship's L) -> out_proj; no scan kernel

in the dtypes and roundings of ssm.py:99-153 ('assoc' is the branch JAX
takes for any other scan_impl, on any backend). On CPU tensors the kernels
run their plain twins; JAX's CPU oracle for every branch is
``pallas_scan.mamba_inner_ref`` (the same math in float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from lfsr_tpu_torch.ops.scan import (
    conv_silu, mamba_inner_fused, mamba_inner_plain, scan_gated_fused, selective_scan_proj,
)

SCAN_IMPLS = ("pallas", "gated", "fused", "assoc")


class Mamba(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: float = 2.0, dt_rank: int | None = None, scan_impl: str = "pallas",
                 dtype=torch.float32, device=None):
        super().__init__()
        if scan_impl not in SCAN_IMPLS:
            raise NotImplementedError(
                f"scan_impl={scan_impl!r} is not ported (ported: {SCAN_IMPLS}); "
                f"see ROADMAP.md section 1")
        D = d_model
        Di = int(expand * D)
        N = d_state
        R = dt_rank or math.ceil(D / 16)
        self.dtype, self.scan_impl, self.R, self.N = dtype, scan_impl, R, N
        self.in_proj = nn.Linear(D, 2 * Di, bias=False, device=device)
        self.conv1d = nn.Conv1d(Di, Di, d_conv, groups=Di, bias=True, device=device)
        self.x_proj = nn.Linear(Di, R + 2 * N, bias=False, device=device)
        self.dt_proj = nn.Linear(R, Di, bias=True, device=device)
        self.A_log = nn.Parameter(torch.empty(Di, N, device=device))
        self.D = nn.Parameter(torch.empty(Di, device=device))
        self.out_proj = nn.Linear(Di, D, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, D] -> [B, L, D] in the compute dtype."""
        dt, R, N = self.dtype, self.R, self.N
        xz = x.to(dt) @ self.in_proj.weight.t().to(dt)
        xs, z = xz.chunk(2, dim=-1)
        wconv = self.conv1d.weight[:, 0, :].t()  # [K, Di]
        w_dt = self.dt_proj.weight.t()  # [R, Di]
        w_out = self.out_proj.weight.t()  # [Di, D]
        A = -torch.exp(self.A_log)
        if self.scan_impl in ("fused", "assoc"):
            inner = mamba_inner_fused if self.scan_impl == "fused" else mamba_inner_plain
            y = inner(xs, z, wconv.contiguous(), self.conv1d.bias,
                      self.x_proj.weight.t().contiguous(), w_dt.contiguous(),
                      self.dt_proj.bias, A, self.D)
            return y.to(dt) @ w_out.to(dt)
        xc = conv_silu(xs, wconv, self.conv1d.bias, dt)
        dbc = xc @ self.x_proj.weight.t().to(dt)
        if self.scan_impl == "gated":
            dt_raw = dbc[..., :R] @ w_dt.to(dt) + self.dt_proj.bias.to(dt)
            return scan_gated_fused(xc, dt_raw, A, dbc[..., R : R + N], dbc[..., R + N :], z,
                                    self.D, w_out.to(dt).contiguous(), True)
        y = selective_scan_proj(xc, dbc, w_dt.contiguous(), self.dt_proj.bias, A, self.D)
        y = y.float() * F.silu(z.float())
        return y.to(dt) @ w_out.to(dt)

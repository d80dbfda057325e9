"""EPIT — EPI-axis transformer (port of lfsr_tpu/models/epit.py).

Per-view conv stem, ``n_blocks`` (5) alternating filters that attend over
the two EPI planes — first over (u, h) tokens batched across (v, w), then
over (v, w) tokens batched across (u, h) — each followed by a shared
3-layer per-view conv, and a pixel-shuffle head over a per-view bicubic
global residual. Submodule and parameter names follow the flax scopes
(``_AltFilter_3._EPITransformer_0.Dense_5``), so ``bridge`` maps the JAX
param tree onto this one.

As in the JAX module, each ``_AltFilter`` owns ONE ``_EPITransformer`` and
ONE ``_ViewConv3`` and calls each twice: both EPI passes share their
parameters. The attention takes K8 (``ops.masked_attention``) exactly where
the JAX module takes its Pallas kernel (``supported(L, d, heads)``; at full
width L = 5 * 32 = 160, d = 128, 8 heads); other geometries run flax
``dot_product_attention`` semantics in plain PyTorch, as JAX runs XLA there.
The banded locality mask is built with numpy on the host and moved to the
device once per geometry.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.common import Conv, LayerNorm, lrelu, pixel_shuffle
from lfsr_tpu_torch.models.losses import l1
from lfsr_tpu_torch.models.registry import register_model
from lfsr_tpu_torch.ops.cross_scan import layer_norm_fast
from lfsr_tpu_torch.ops.layout import sai_to_views, views_to_sai
from lfsr_tpu_torch.ops.masked_attention import masked_mha_fused, supported
from lfsr_tpu_torch.ops.resize import interpolate

HEADS = 8
BAND = 11  # spatial window of the locality mask


@functools.lru_cache(maxsize=32)
def _band_mask(rows: int, cols: int, k_r: int, k_c: int) -> np.ndarray:
    """Additive attention mask over a (rows, cols) token grid: token (i, j)
    may attend to (k, l) iff k in [i - k_r//2, i + ceil(k_r/2)) and l in
    [j - k_c//2, j + ceil(k_c/2)) (the JAX module's ``_band_mask``)."""
    r = np.arange(rows)
    c = np.arange(cols)
    ok_r = (r[None, :] - r[:, None] >= -(k_r // 2)) & (r[None, :] - r[:, None] < k_r - k_r // 2)
    ok_c = (c[None, :] - c[:, None] >= -(k_c // 2)) & (c[None, :] - c[:, None] < k_c - k_c // 2)
    ok = ok_r[:, None, :, None] & ok_c[None, :, None, :]
    ok = ok.reshape(rows * cols, rows * cols)
    return np.where(ok, 0.0, -np.inf).astype(np.float32)


@functools.lru_cache(maxsize=32)
def band_mask(rows: int, cols: int, k_r: int, k_c: int, device: torch.device) -> torch.Tensor:
    """:func:`_band_mask` as a float32 tensor on ``device`` (one copy per
    geometry and device). Made outside inference mode, so a mask first built
    during evaluation can be saved for a later training step's backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(_band_mask(rows, cols, k_r, k_c), device=device)


def dense(lin: nn.Linear, x: torch.Tensor, dt) -> torch.Tensor:
    """flax ``nn.Dense(use_bias=False, dtype=dt)``: x and the kernel cast to dt."""
    return x.to(dt) @ lin.weight.t().to(dt)


def dot_product_attention(q, k, v, mask, heads: int):
    """flax ``nn.dot_product_attention`` over channel-contiguous heads with
    an additive [L, L] bias: q scaled by 1/sqrt(hd) and the scores taken in
    q's dtype, bias added (float32), softmax in float32 cast back to q's
    dtype, weighted values in q's dtype. q, k, v [B, L, D] -> [B, L, D]."""
    B, L, D = q.shape
    hd = D // heads
    dt = q.dtype
    split = lambda a: a.reshape(B, L, heads, hd)
    qs = split(q) / torch.tensor(hd**0.5, dtype=dt, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, split(k))
    p = torch.softmax(s.float() + mask.float(), dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p, split(v)).reshape(B, L, D)


class _EPITransformer(nn.Module):
    """Pre-norm MHA over EPI tokens + FFN. The q/k projections read the
    LayerNormed tokens, the value projection the raw ones; no projection
    has a bias. LayerNorms are flax's (fast variance, eps 1e-6, float32
    statistics, output in the compute dtype)."""

    def __init__(self, channels: int, spa_dim: int, heads: int, dt, device=None):
        super().__init__()
        d = spa_dim
        self.spa_dim, self.heads, self.dtype = d, heads, dt
        lin = lambda i, o: nn.Linear(i, o, bias=False, device=device)
        self.Dense_0 = lin(channels, d)
        self.LayerNorm_0 = LayerNorm(d, device=device)
        self.Dense_1, self.Dense_2, self.Dense_3, self.Dense_4 = (lin(d, d) for _ in range(4))
        self.LayerNorm_1 = LayerNorm(d, device=device)
        self.Dense_5 = lin(d, 2 * d)
        self.Dense_6 = lin(2 * d, d)
        self.Dense_7 = lin(d, channels)

    def _ln(self, ln: LayerNorm, x):
        return layer_norm_fast(x, ln.weight, ln.bias).to(self.dtype)

    def forward(self, tok, mask):
        # tok [B', L, C]; mask [L, L] additive float32
        dt = self.dtype
        t = dense(self.Dense_0, tok, dt)
        tn = self._ln(self.LayerNorm_0, t)
        q = dense(self.Dense_1, tn, dt)
        k = dense(self.Dense_2, tn, dt)
        v = dense(self.Dense_3, t, dt)
        L = q.shape[1]
        if supported(L, self.spa_dim, self.heads):
            attn = masked_mha_fused(q, k, v, mask, self.heads)
        else:
            attn = dot_product_attention(q, k, v, mask, self.heads)
        t = t + dense(self.Dense_4, attn, dt)
        f = self._ln(self.LayerNorm_1, t)
        f = torch.relu(dense(self.Dense_5, f, dt))
        t = t + dense(self.Dense_6, f, dt)
        return dense(self.Dense_7, t, dt)


class _ViewConv3(nn.Module):
    """Shared 3-layer per-view 3x3 conv, applied to every view on its own.
    The stem's stack ends with a LeakyReLU(0.2), the AltFilter's does not."""

    def __init__(self, feats: int, dt, final_act: bool = False, device=None):
        super().__init__()
        self.final_act = final_act
        conv = lambda: Conv(feats, feats, 3, padding=1, bias=False, dtype=dt, device=device)
        self.Conv_0, self.Conv_1, self.Conv_2 = conv(), conv(), conv()

    def forward(self, x):
        # x [B, N, h, w, C] -> views folded into the batch
        b, n, h, w, c = x.shape
        y = x.reshape(b * n, h, w, c)
        y = lrelu(self.Conv_0(y), 0.2)
        y = lrelu(self.Conv_1(y), 0.2)
        y = self.Conv_2(y)
        if self.final_act:
            y = lrelu(y, 0.2)
        return y.reshape(b, n, h, w, c)


class _AltFilter(nn.Module):
    def __init__(self, ang: int, feats: int, dt, device=None):
        super().__init__()
        self.ang = ang
        self._EPITransformer_0 = _EPITransformer(feats, 2 * feats, HEADS, dt, device=device)
        self._ViewConv3_0 = _ViewConv3(feats, dt, device=device)

    def forward(self, x):
        # x [B, U, V, h, w, C]
        a = self.ang
        b, u, v, h, w, c = x.shape
        trans, cstack = self._EPITransformer_0, self._ViewConv3_0
        shortcut = x

        # pass 1: attend over (u, h) tokens, batched over (b, v, w)
        mask = band_mask(u, h, 2 * a, BAND, x.device)
        t = x.permute(0, 2, 4, 1, 3, 5).reshape(b * v * w, u * h, c)
        t = trans(t, mask)
        x = t.reshape(b, v, w, u, h, c).permute(0, 3, 1, 4, 2, 5)
        x = cstack(x.reshape(b, u * v, h, w, c)).reshape(b, u, v, h, w, c) + shortcut

        # pass 2: attend over (v, w) tokens, batched over (b, u, h)
        mask = band_mask(v, w, 2 * a, BAND, x.device)
        t = x.permute(0, 1, 3, 2, 4, 5).reshape(b * u * h, v * w, c)
        t = trans(t, mask)
        y = t.reshape(b, u, h, v, w, c).permute(0, 1, 3, 2, 4, 5)
        return cstack(y.reshape(b, u * v, h, w, c)).reshape(b, u, v, h, w, c) + shortcut


@register_model("EPIT", loss=lambda cfg: l1)
class EPIT(nn.Module):
    """Config overrides (``cfg.model_kwargs``): channels (64), n_blocks (5)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        a, s = cfg.angRes, cfg.scale_factor
        feats = cfg.mk("channels", 64)
        dt = getattr(torch, cfg.compute_dtype)
        self.cfg, self.dtype, self.feats = cfg, dt, feats
        self.Conv_0 = Conv(1, feats, 3, padding=1, bias=False, dtype=dt, device=device)
        self._ViewConv3_0 = _ViewConv3(feats, dt, final_act=True, device=device)
        self.n_blocks = cfg.mk("n_blocks", 5)
        for i in range(self.n_blocks):
            setattr(self, f"_AltFilter_{i}", _AltFilter(a, feats, dt, device=device))
        self.Conv_1 = Conv(feats, feats * s * s, 1, bias=False, dtype=dt, device=device)
        self.Conv_2 = Conv(feats, 1, 3, padding=1, bias=False, dtype=dt, device=device)

    def init_constants(self) -> dict[str, float]:
        """Parameters whose init is a constant (``bridge.init_params``): none."""
        return {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 1] float32 SAI patches -> [B, H*s, W*s, 1] float32."""
        a, s, dt, feats = self.cfg.angRes, self.cfg.scale_factor, self.dtype, self.feats
        # global residual: per-view bicubic, so views do not blur into each other
        v = sai_to_views(x[..., 0], a)  # [B, U, V, h, w]
        b, u, vv, h, w = v.shape
        vu = interpolate(v.reshape(b * u * vv, 1, h, w), s)
        up = views_to_sai(vu.reshape(b, u, vv, h * s, w * s))[..., None]

        y = self.Conv_0(v.to(dt).reshape(b * u * vv, h, w, 1))
        y = y.reshape(b, u * vv, h, w, feats)
        y = self._ViewConv3_0(y) + y
        y = y.reshape(b, u, vv, h, w, feats)

        skip = y
        for i in range(self.n_blocks):
            y = getattr(self, f"_AltFilter_{i}")(y)
        y = y + skip

        sai = views_to_sai(y.permute(0, 5, 1, 2, 3, 4)).permute(0, 2, 3, 1)  # [B, U*h, V*w, C]
        out = lrelu(pixel_shuffle(self.Conv_1(sai), s), 0.2)
        out = self.Conv_2(out)
        return out.float() + up

"""LFT — Light Field Transformer (port of lfsr_tpu/models/lft.py).

Per-view conv stem, ``n_blocks`` (4) alternating blocks of

- AngTrans: full multi-head attention over the A^2 = 25 angular tokens of
  every LR pixel (dim = channels, 8 heads), batched over every (view batch,
  y, x); the attention is K8 (``ops.masked_attention``) with a zero [25, 25]
  mask;
- SpaTrans: attention over each view's h*w spatial tokens, embedded from
  3x3 neighbourhoods to dim 2*channels (the unfold + Dense run as one 3x3
  conv with the Dense kernel reshaped: the same products), 8 heads under a
  5x5 sliding-window mask: K12 (``ops.local_attention``);

with sinusoidal position codes added to queries and keys only (values read
the raw tokens), and a pixel-shuffle head over a per-view bicubic residual.
Each stage's two LayerNorms are K13 (``ops.layer_norm``), the first with
the add of the position code folded in.
Submodule and parameter names follow the flax scopes
(``_SpaTrans_2._MHA_0.Dense_4``, ``_SpaTrans_0.embed``), so ``bridge`` maps
the JAX param tree onto this one.

The position codes and K8's zero mask are made with numpy on the host and
moved to the device once per geometry; SpaTrans's embedded code is
recomputed from the current weights each forward, as in JAX. LFT's spatial
code and band were trained at 32x32 patches: it evaluates tiled
(``whole_scene_ok`` False), as in the JAX registry.

A forward runs in the spans (``trace.span``) ``model.input`` (bicubic
residual, views), ``model.stem``, ``model.ang`` and ``model.spa`` (one a
block, with ``model.ang.attn`` and ``model.spa.attn`` around the K8 and K12
calls) and ``model.output``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.common import Conv, LayerNorm, dense, lrelu, pixel_shuffle
from lfsr_tpu_torch.models.losses import l1
from lfsr_tpu_torch.models.registry import register_model
from lfsr_tpu_torch.ops.layer_norm import layer_norm
from lfsr_tpu_torch.ops.layout import sai_to_views, views_to_sai
from lfsr_tpu_torch.ops.local_attention import local_window_mha
from lfsr_tpu_torch.ops.masked_attention import masked_mha_fused
from lfsr_tpu_torch.ops.resize import interpolate

HEADS = 8
BAND = 5  # SpaTrans's window, both axes


@functools.lru_cache(maxsize=16)
def _sincos_1d(length: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """One axis's sinusoidal code [length, dim] (the JAX ``_sincos_1d``):
    columns 0::2 of the angle table as sin, 1::2 as cos, concatenated."""
    grid = temperature ** (2 * (np.arange(dim, dtype=np.float64) // 2) / dim)
    pos = np.arange(length, dtype=np.float64)[:, None] / grid[None, :]
    return np.concatenate([np.sin(pos[:, 0::2]), np.cos(pos[:, 1::2])], axis=1).astype(np.float32)


def spa_position(h: int, w: int, dim: int) -> np.ndarray:
    """[h, w, dim]: the mean of the row's and the column's codes."""
    return ((_sincos_1d(h, dim)[:, None, :] + _sincos_1d(w, dim)[None, :, :]) / 2.0).astype(
        np.float32)


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host constant on ``device``, made outside inference mode (so a
    training step may save it for its backward)."""
    with torch.inference_mode(False):
        return trace.upload(host, device)


@functools.lru_cache(maxsize=32)
def ang_code(n: int, c: int, device: torch.device) -> torch.Tensor:
    """The angular code [1, n, c] on ``device``, once per geometry."""
    return _to_device(_sincos_1d(n, c)[None], device)


@functools.lru_cache(maxsize=32)
def spa_code(h: int, w: int, c: int, device: torch.device) -> torch.Tensor:
    """The spatial code [1, h, w, c] on ``device``, once per geometry."""
    return _to_device(spa_position(h, w, c)[None], device)


@functools.lru_cache(maxsize=32)
def zero_mask(n: int, device: torch.device) -> torch.Tensor:
    """K8's additive mask for attention over all n tokens: [n, n] zeros."""
    return _to_device(np.zeros((n, n), np.float32), device)


class _MHA(nn.Module):
    """Pre-norm attention + FFN with torch-MHA's convention: q and k from
    the LayerNormed (tokens + code), v from the raw tokens, no projection
    bias; LayerNorms are flax's (fast variance, eps 1e-6, float32
    statistics, output in the compute dtype)."""

    def __init__(self, dim: int, dt, device=None):
        super().__init__()
        lin = lambda i, o: nn.Linear(i, o, bias=False, device=device)
        self.dtype = dt
        self.LayerNorm_0 = LayerNorm(dim, device=device)
        self.Dense_0, self.Dense_1, self.Dense_2, self.Dense_3 = (lin(dim, dim) for _ in range(4))
        self.LayerNorm_1 = LayerNorm(dim, device=device)
        self.Dense_4 = lin(dim, 2 * dim)
        self.Dense_5 = lin(2 * dim, dim)

    def _ln(self, ln: LayerNorm, x, add=None):
        return layer_norm(x, ln.weight, ln.bias, add, self.dtype)

    def forward(self, tok, pe, attend, span: str):
        dt = self.dtype
        tn = self._ln(self.LayerNorm_0, tok, pe)
        q, k = dense(self.Dense_0, tn, dt), dense(self.Dense_1, tn, dt)
        v = dense(self.Dense_2, tok, dt)
        with trace.span(span):
            o = attend(q, k, v)
        tok = tok + dense(self.Dense_3, o, dt)
        f = self._ln(self.LayerNorm_1, tok)
        f = dense(self.Dense_5, torch.relu(dense(self.Dense_4, f, dt)), dt)
        return tok + f


class _AngTrans(nn.Module):
    def __init__(self, channels: int, dt, device=None):
        super().__init__()
        self._MHA_0 = _MHA(channels, dt, device=device)

    def forward(self, x):
        # x [B, N, h, w, C], N = A^2 angular tokens; the code is float32, so
        # tokens + code is float32 before the LayerNorm, as in JAX
        b, n, h, w, c = x.shape
        pe, mask = ang_code(n, c, x.device), zero_mask(n, x.device)
        tok = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, n, c)
        attend = lambda q, k, v: masked_mha_fused(q, k, v, mask, HEADS)
        tok = self._MHA_0(tok, pe, attend, "model.ang.attn")
        return tok.reshape(b, h, w, n, c).permute(0, 3, 1, 2, 4)


class _SpaTrans(nn.Module):
    def __init__(self, channels: int, dt, device=None):
        super().__init__()
        d = 2 * channels
        self.channels, self.dtype = channels, dt
        self.embed = nn.Linear(9 * channels, d, bias=False, device=device)
        self._MHA_0 = _MHA(d, dt, device=device)
        self.Dense_0 = nn.Linear(d, channels, bias=False, device=device)

    def _embed(self, x):
        """Dense over each token's zero-padded 3x3 neighbourhood (channels
        in (dy, dx, c) order), as a 3x3 conv: [B', h, w, C] -> [B', h*w, d]."""
        dt, c = self.dtype, self.channels
        wk = self.embed.weight.reshape(-1, 3, 3, c).permute(0, 3, 1, 2).to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), wk, padding=1)
        return y.flatten(2).transpose(1, 2)

    def forward(self, x):
        # x [B, N, h, w, C]; tokens over (h, w)
        b, n, h, w, c = x.shape
        tok = self._embed(x.reshape(b * n, h, w, c))
        pe = self._embed(spa_code(h, w, c, x.device))
        attend = lambda q, k, v: local_window_mha(q, k, v, HEADS, h, w, BAND, BAND)
        tok = self._MHA_0(tok, pe, attend, "model.spa.attn")
        return dense(self.Dense_0, tok, self.dtype).reshape(b, n, h, w, c)


class _ViewConv3Act(nn.Module):
    """Per-view stack of three 3x3 convs, each followed by a LeakyReLU(0.2)."""

    def __init__(self, feats: int, dt, device=None):
        super().__init__()
        conv = lambda: Conv(feats, feats, 3, padding=1, bias=False, dtype=dt, device=device)
        self.Conv_0, self.Conv_1, self.Conv_2 = conv(), conv(), conv()

    def forward(self, x):
        b, n, h, w, c = x.shape
        y = x.reshape(b * n, h, w, c)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            y = lrelu(conv(y), 0.2)
        return y.reshape(b, n, h, w, c)


@register_model("LFT", loss=lambda cfg: l1)
class LFT(nn.Module):
    """Config overrides (``cfg.model_kwargs``): channels (64), n_blocks (4)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        s = cfg.scale_factor
        feats = cfg.mk("channels", 64)
        dt = getattr(torch, cfg.compute_dtype)
        self.cfg, self.dtype, self.feats = cfg, dt, feats
        self.Conv_0 = Conv(1, feats, 3, padding=1, bias=False, dtype=dt, device=device)
        self._ViewConv3Act_0 = _ViewConv3Act(feats, dt, device=device)
        self.n_blocks = cfg.mk("n_blocks", 4)
        for i in range(self.n_blocks):
            setattr(self, f"_AngTrans_{i}", _AngTrans(feats, dt, device=device))
            setattr(self, f"_SpaTrans_{i}", _SpaTrans(feats, dt, device=device))
        self.Conv_1 = Conv(feats, feats * s * s, 1, bias=False, dtype=dt, device=device)
        self.Conv_2 = Conv(feats, 1, 3, padding=1, bias=False, dtype=dt, device=device)

    def init_constants(self) -> dict[str, float]:
        """Parameters whose init is a constant (``bridge.init_params``): none."""
        return {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 1] float32 SAI patches -> [B, H*s, W*s, 1] float32."""
        a, s, dt, feats = self.cfg.angRes, self.cfg.scale_factor, self.dtype, self.feats
        with trace.span("model.input"):
            v = sai_to_views(x[..., 0], a)  # [B, U, V, h, w]
            b, u, vv, h, w = v.shape
            vu = interpolate(v.reshape(b * u * vv, 1, h, w), s)
            up = views_to_sai(vu.reshape(b, u, vv, h * s, w * s))[..., None]
            views = v.to(dt).reshape(b * u * vv, h, w, 1)
        with trace.span("model.stem"):
            y = self.Conv_0(views).reshape(b, u * vv, h, w, feats)
            y = self._ViewConv3Act_0(y) + y
        skip = y
        for i in range(self.n_blocks):
            with trace.span("model.ang"):
                y = getattr(self, f"_AngTrans_{i}")(y)
            with trace.span("model.spa"):
                y = getattr(self, f"_SpaTrans_{i}")(y)
        with trace.span("model.output"):
            y = y + skip
            sai = views_to_sai(y.reshape(b, u, vv, h, w, feats).permute(0, 5, 1, 2, 3, 4))
            out = lrelu(pixel_shuffle(self.Conv_1(sai.permute(0, 2, 3, 1)), s), 0.2)
            return self.Conv_2(out).float() + up

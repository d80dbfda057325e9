"""LF-DET — spatial-angular separable transformer with multi-scale angular
aggregation (port of lfsr_tpu/models/lf_det.py; Cong et al., IEEE TMM 2023,
BasicLFSR ``model/SR/LF_DET.py``).

Per-view conv stem; ``depth`` (4) mix blocks, each

- two spatial transformer blocks over each view's h*w pixel tokens: their
  attention is spatial-reduction attention (keys and values from a 2x2
  stride-2 conv and a LayerNorm: 1,024 queries against 256 keys at 32x32
  views), then a Mix-FFN (Dense x4, a 3x3 depthwise conv with bias, GELU,
  Dense back);
- three parallel angular branches, each the same block (no reduction) over
  the MacPI's ws x ws windows, ws = A, 2A, 3A (25, 100 and 225 tokens at A
  5): where ws does not divide the MacPI, extra windows end at its edges and
  the overlaps are averaged (``ops.layout.macpi_windows`` /
  ``windows_average``: one gather and one scatter-add a branch);
- a 1x1 conv with a softmax over the three branches fusing them;

hierarchical top-down (MLA) aggregation of the four blocks' outputs (64 ->
32 -> 32 channels a level), a 1x1 conv to 16C, pixel shuffle, LeakyReLU
0.1, a 3x3 conv to one channel, and a per-view bicubic residual.

Every attention is K15 (``ops.dense_attention.dense_mha``, 20 a forward),
every LayerNorm K13 (``ops.layer_norm``, 48 a forward), every Mix-FFN
depthwise conv K11 in its ``"once"`` rounding (``Conv``). Dense layers keep
flax's defaults (biases, the compute dtype), LayerNorms flax's (eps 1e-6,
float32 statistics), GELU flax's tanh form. The Dense layers' biases and
the spatial reduction's ride in the products' epilogues
(``common.biased_product``, 108 a forward: one rounding where flax rounds
twice). DropPath (per sample, rate 0.1 i / 7 over the 8 slots; the angular
branches take a block's second) acts in train mode only and draws from the
forward's ``generator``. Submodule and
parameter names follow the flax scopes (``_MixBlock_2._AngularWindows_1.
_Block_0._Attention_0.Dense_1``), so ``bridge`` maps the JAX tree onto
this one; it evaluates tiled (``whole_scene_ok`` False), as in the JAX
registry.

A forward runs in the spans (``trace.span``) ``model.input``,
``model.stem``, ``model.spa`` (two a mix block, child ``model.spa.attn``
around K15), ``model.ang`` (one a mix block, children ``model.ang.windows``
around each gather and average, ``model.ang.attn`` around K15,
``model.ang.fuse``), ``model.mla`` and ``model.output``; the counters
``lfdet/windows/<ws>`` count the windows each branch runs and
``lfdet/windows/edge`` those of them added at an edge, and
``dense/bias_epilogue`` the biased products.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.common import (
    Conv, LayerNorm, biased_product, dense, lrelu, pixel_shuffle,
)
from lfsr_tpu_torch.models.losses import l1
from lfsr_tpu_torch.models.registry import register_model
from lfsr_tpu_torch.ops.dense_attention import dense_mha
from lfsr_tpu_torch.ops.layer_norm import layer_norm
from lfsr_tpu_torch.ops.layout import (
    macpi_to_views, macpi_windows, sai_to_views, views_to_macpi, views_to_sai, window_count,
    windows_average,
)
from lfsr_tpu_torch.ops.resize import interpolate

HEADS = 4
MLP_RATIO = 4
SR_RATIO = 2  # the spatial blocks' key/value reduction
SPA_BLOCKS = 2
WINDOW_SCALES = (1, 2, 3)  # angular windows of A, 2A and 3A pixels a side


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout`` broadcast over all but the first axis: each row
    of x kept with probability 1 - rate and scaled by 1 / (1 - rate) in x's
    dtype, the keep mask drawn from ``generator`` (on x's device)."""
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                      device=x.device) < keep
    return torch.where(mask, x / trace.upload(keep, x.device, x.dtype), 0)


class _Attention(nn.Module):
    """Multi-head attention, flax's Dense layers (with biases) for q, kv and
    the output; with ``sr`` > 1 the keys and values come from the tokens'
    sr x sr stride-sr conv (a product over each patch: the conv's own
    products, 'VALID' as in flax) and a LayerNorm."""

    def __init__(self, dim: int, sr: int, dt, device=None):
        super().__init__()
        self.dim, self.sr, self.dtype = dim, sr, dt
        self.Dense_0 = nn.Linear(dim, dim, device=device)
        if sr > 1:
            self.Conv_0 = Conv(dim, dim, sr, bias=True, dtype=dt, device=device)
            self.LayerNorm_0 = LayerNorm(dim, device=device)
        self.Dense_1 = nn.Linear(dim, 2 * dim, device=device)
        self.Dense_2 = nn.Linear(dim, dim, device=device)

    def _reduce(self, x, h: int, w: int):
        """[B, h*w, C] -> [B, (h//sr)*(w//sr), C]: the strided conv, its bias
        in the product's epilogue."""
        b, _, c = x.shape
        r, dt = self.sr, self.dtype
        hr, wr = h // r, w // r
        g = x.reshape(b, h, w, c)[:, : hr * r, : wr * r]
        g = g.reshape(b, hr, r, wr, r, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hr * wr, r * r * c)
        wk = self.Conv_0.weight.permute(2, 3, 1, 0).reshape(r * r * c, c)  # (ky, kx, c_in) x c_out
        red = biased_product(g, wk, self.Conv_0.bias, dt)
        ln = self.LayerNorm_0
        return layer_norm(red, ln.weight, ln.bias, None, dt)

    def forward(self, x, h: int, w: int, span: str):
        dt, c = self.dtype, self.dim
        q = dense(self.Dense_0, x, dt)
        kv = dense(self.Dense_1, self._reduce(x, h, w) if self.sr > 1 else x, dt)
        with trace.span(span):
            o = dense_mha(q, kv[..., :c], kv[..., c:], HEADS)
        return dense(self.Dense_2, o, dt)


class _Mlp(nn.Module):
    """Mix-FFN: Dense x ratio, the 3x3 depthwise conv with bias over the
    tokens' h x w grid (K11), GELU (tanh form), Dense back."""

    def __init__(self, dim: int, dt, device=None):
        super().__init__()
        hid = dim * MLP_RATIO
        self.dtype = dt
        self.Dense_0 = nn.Linear(dim, hid, device=device)
        self.Conv_0 = Conv(hid, hid, 3, padding=1, groups=hid, bias=True, dtype=dt, device=device)
        self.Dense_1 = nn.Linear(hid, dim, device=device)

    def forward(self, x, h: int, w: int):
        b, n, _ = x.shape
        y = dense(self.Dense_0, x, self.dtype)
        g = self.Conv_0(y.reshape(b, h, w, -1)).reshape(b, n, -1)
        return dense(self.Dense_1, F.gelu(g, approximate="tanh"), self.dtype)


class _Block(nn.Module):
    """Pre-norm transformer block: x + DropPath(attention(LN x)), then
    x + DropPath(Mix-FFN(LN x)); LayerNorms are K13."""

    def __init__(self, dim: int, sr: int, drop: float, dt, device=None):
        super().__init__()
        self.drop, self.dtype = drop, dt
        self.LayerNorm_0 = LayerNorm(dim, device=device)
        self._Attention_0 = _Attention(dim, sr, dt, device=device)
        self.LayerNorm_1 = LayerNorm(dim, device=device)
        self._Mlp_0 = _Mlp(dim, dt, device=device)

    def _ln(self, ln: LayerNorm, x):
        return layer_norm(x, ln.weight, ln.bias, None, self.dtype)

    def _dp(self, y, generator):
        return drop_path(y, self.drop, generator) if self.training and self.drop > 0 else y

    def forward(self, x, h: int, w: int, span: str, generator=None):
        x = x + self._dp(self._Attention_0(self._ln(self.LayerNorm_0, x), h, w, span), generator)
        return x + self._dp(self._Mlp_0(self._ln(self.LayerNorm_1, x), h, w), generator)


class _AngularWindows(nn.Module):
    """One angular branch: the block over the MacPI's ws x ws windows, edge
    windows and the overlap average where ws does not divide the map."""

    def __init__(self, dim: int, ws: int, drop: float, dt, device=None):
        super().__init__()
        self.ws = ws
        self._Block_0 = _Block(dim, 1, drop, dt, device=device)

    def forward(self, macpi, generator=None):
        b, H, W, _ = macpi.shape
        ws = self.ws
        n, edge = window_count(H, W, ws)
        trace.count(f"lfdet/windows/{ws}", b * n)
        trace.count("lfdet/windows/edge", b * edge)
        with trace.span("model.ang.windows"):
            toks = macpi_windows(macpi, ws)
        toks = self._Block_0(toks, ws, ws, "model.ang.attn", generator)
        with trace.span("model.ang.windows"):
            return windows_average(toks, ws, H, W)


class _MixBlock(nn.Module):
    def __init__(self, dim: int, ang: int, drops: tuple, dt, device=None):
        super().__init__()
        self.ang = ang
        for i in range(SPA_BLOCKS):
            setattr(self, f"_Block_{i}", _Block(dim, SR_RATIO, drops[i], dt, device=device))
        for m, scale in enumerate(WINDOW_SCALES):
            setattr(self, f"_AngularWindows_{m}",
                    _AngularWindows(dim, scale * ang, drops[-1], dt, device=device))
        self.Conv_0 = Conv(len(WINDOW_SCALES) * dim, len(WINDOW_SCALES), 1, bias=True, dtype=dt,
                           device=device)

    def forward(self, views, generator=None):
        # views [B, U, V, h, w, C]
        b, u, v, h, w, c = views.shape
        toks = views.reshape(b * u * v, h * w, c)
        for i in range(SPA_BLOCKS):
            with trace.span("model.spa"):
                toks = getattr(self, f"_Block_{i}")(toks, h, w, "model.spa.attn", generator)
        with trace.span("model.ang"):
            views = toks.reshape(b, u, v, h, w, c).permute(0, 5, 1, 2, 3, 4)
            macpi = views_to_macpi(views).permute(0, 2, 3, 1)  # [B, h*U, w*V, C]
            branches = [getattr(self, f"_AngularWindows_{m}")(macpi, generator)
                        for m in range(len(WINDOW_SCALES))]
            with trace.span("model.ang.fuse"):
                attn = torch.softmax(self.Conv_0(torch.cat(branches, -1)), dim=-1)
                fused = attn[..., 0:1] * branches[0]
                for m in range(1, len(branches)):
                    fused = fused + attn[..., m : m + 1] * branches[m]
                out = macpi_to_views(fused.permute(0, 3, 1, 2), self.ang)  # [B, C, U, V, h, w]
                return out.permute(0, 2, 3, 4, 5, 1)


@register_model("LF_DET", loss=lambda cfg: l1)
class LFDET(nn.Module):
    """Config overrides (``cfg.model_kwargs``): channels (64), depth (4)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        a, s = cfg.angRes, cfg.scale_factor
        c = cfg.mk("channels", 64)
        depth = cfg.mk("depth", 4)
        dt = getattr(torch, cfg.compute_dtype)
        self.cfg, self.dtype, self.feats, self.depth = cfg, dt, c, depth
        conv3 = lambda i, o: Conv(i, o, 3, padding=1, bias=False, dtype=dt, device=device)
        self.Conv_0 = conv3(1, c)
        self.Conv_1, self.Conv_2, self.Conv_3 = conv3(c, c), conv3(c, c), conv3(c, c)
        total = depth * 2
        dpr = [0.1 * i / max(1, total - 1) for i in range(total)]
        for i in range(depth):
            setattr(self, f"_MixBlock_{i}",
                    _MixBlock(c, a, tuple(dpr[2 * i : 2 * i + 2]), dt, device=device))
        # MLA: three convs a level, deepest level first (flax's creation order)
        for lvl in range(depth):
            n = 4 + 3 * lvl
            setattr(self, f"Conv_{n}", conv3(c, c))
            setattr(self, f"Conv_{n + 1}", conv3(c, c // 2))
            setattr(self, f"Conv_{n + 2}", conv3(c // 2, c // 2))
        n = 4 + 3 * depth
        self.up = f"Conv_{n}"
        setattr(self, f"Conv_{n}", Conv(depth * (c // 2), c * s * s, 1, bias=False, dtype=dt,
                                        device=device))
        self.last = f"Conv_{n + 1}"
        setattr(self, f"Conv_{n + 1}", conv3(c, 1))

    def init_constants(self) -> dict[str, float]:
        """Parameters whose init is a constant (``bridge.init_params``): none."""
        return {}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, H, W, 1] float32 SAI patches -> [B, H*s, W*s, 1] float32. In
        train mode DropPath draws from ``generator`` (flax's
        ``rngs={"dropout": key}``), which is then required."""
        if self.training and generator is None:
            raise ValueError("LF_DET in train mode needs a DropPath generator")
        a, s, dt, c = self.cfg.angRes, self.cfg.scale_factor, self.dtype, self.feats
        with trace.span("model.input"):
            v = sai_to_views(x[..., 0], a)  # [B, U, V, h, w]
            b, u, vv, h, w = v.shape
            vu = interpolate(v.reshape(b * u * vv, 1, h, w), s)
            up = views_to_sai(vu.reshape(b, u, vv, h * s, w * s))[..., None]
            flat = v.reshape(b * u * vv, h, w, 1).to(dt)
        with trace.span("model.stem"):
            y0 = self.Conv_0(flat)
            y = y0
            for conv in (self.Conv_1, self.Conv_2, self.Conv_3):
                y = lrelu(conv(y))
            feat = (y + y0).reshape(b, u, vv, h, w, c)
        hier = []
        for i in range(self.depth):
            feat = getattr(self, f"_MixBlock_{i}")(feat, generator)
            hier.append(feat)
        with trace.span("model.mla"):
            fused, acc = [], None
            for lvl, f in enumerate(reversed(hier)):
                acc = f if acc is None else acc + f
                g = acc.reshape(b * u * vv, h, w, c)
                for j in range(3):
                    g = lrelu(getattr(self, f"Conv_{4 + 3 * lvl + j}")(g))
                fused.append(g)
            agg = torch.cat(fused[::-1], -1)  # [B', h, w, depth * C / 2]
        with trace.span("model.output"):
            y = lrelu(pixel_shuffle(getattr(self, self.up)(agg), s))
            y = getattr(self, self.last)(y)
            out = views_to_sai(y.reshape(b, u, vv, h * s, w * s, 1)[..., 0], a)[..., None]
            return out.float() + up

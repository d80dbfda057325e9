"""LFMambaX — the flagship model (port of lfsr_tpu/models/lfmambax.py).

Same four-module layout and the same parameter tree (submodule and
parameter names follow the flax scopes, so ``bridge`` maps one onto the
other): IFE -> 12 LFVSSMBlocks in phases with window attention after
phases 0 and 1 -> SpatialAttention -> LSFL, + 4-stage ProgressiveFusion ->
HLFR. Activations are NHWC; the compute dtype (bf16 by default) is cast in
exactly where the JAX module casts, and the float32 promotions the JAX
model makes (a float32 ``scale`` parameter times a bf16 tensor) are kept,
so the residual stream between blocks is float32 as on the TPU.

The kernels on this model's path run as the port's CUDA kernels on CUDA
tensors: K1 (Mamba scan; K2/K3 forward and adjoint when a gradient is
wanted; K9b or K9c in its place under ``model_kwargs={'scan_impl': 'gated'
| 'fused'}``), K4/K5 (cross-scan gather and scatter), K6 (window
attention), K7 (LayerNorm + local branch: on the float32 residual stream
below the TPU's gate, on it rounded to the compute dtype at the gate, so
JAX's two branches), once per forward K10 (the HLFR tail: expansion
matmul + lrelu + the folded out-conv), and K11 at the 13 depthwise convs
outside the blocks (``dw_apply``'s 11 in the JAX ``_dw_apply`` rounding,
LSFL's two EPI convs in a conv's).
``module.train()`` turns on the blocks' dropout (JAX ``train=True``).

A forward runs in the spans (``trace.span``) ``model.input``,
``model.ife``, ``model.block`` (each block, with ``model.block.ssm`` around
its cross-scan SSM), ``model.window_attention``, ``model.fusion``,
``model.hlfr`` and ``model.output``; its host data (the window index
table, the folded out-conv's matrix, dropout's scale) goes up through
``trace.upload``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.cnn_baselines import bicubic_up
from lfsr_tpu_torch.models.common import (
    Conv, LayerNorm, dw_apply, lrelu, mix_kernel, pixel_shuffle, pw_apply,
)
from lfsr_tpu_torch.models.losses import composite_v8_builder
from lfsr_tpu_torch.models.registry import register_model
from lfsr_tpu_torch.models.ssm import Mamba
from lfsr_tpu_torch.ops.block import ln_msl, ln_msl_supported, ln_msl_takes
from lfsr_tpu_torch.ops.cross_scan import (
    cross_scan_gather, cross_scan_scatter, layer_norm_fast,
)
from lfsr_tpu_torch.ops.head import hlfr_tail
from lfsr_tpu_torch.ops.layout import macpi_to_sai, sai_to_macpi
from lfsr_tpu_torch.ops.window_attention import window_mha_fused


def _dw(c: int, dt, dilation: int = 1, device=None) -> Conv:
    """Depthwise 3x3 conv (no bias) with 'same' padding."""
    return Conv(c, c, 3, dilation=dilation, padding=dilation, groups=c, bias=False,
                dtype=dt, device=device)


def _pw(c_in: int, c_out: int, dt, bias: bool = False, device=None) -> Conv:
    return Conv(c_in, c_out, 1, bias=bias, dtype=dt, device=device)


class ECA(nn.Module):
    """Efficient channel attention."""

    def __init__(self, c: int, dt, reduction: int = 8, device=None):
        super().__init__()
        hidden = max(c // reduction, 16)
        self.Conv_0 = _pw(c, hidden, dt, bias=True, device=device)
        self.Conv_1 = _pw(hidden, c, dt, bias=True, device=device)

    def forward(self, x):
        y = x.mean(dim=(1, 2), keepdim=True)
        y = torch.relu(self.Conv_0(y))
        return x * torch.sigmoid(self.Conv_1(y))


class IFE(nn.Module):
    """Multi-scale (3/5/7) initial feature extraction. The 5x5 and 7x7
    single-output convs stay two named kernels (Conv_2, Conv_4); the JAX
    module runs them as one zero-padded 2-channel 7x7 conv — the same map."""

    def __init__(self, feats: int, dt, device=None):
        super().__init__()
        c3 = feats // 3
        self.dtype = dt
        self.c3 = c3
        self.Conv_0 = Conv(1, c3, 3, padding=1, dtype=dt, device=device)
        self.Conv_1 = _pw(1, c3, dt, bias=True, device=device)
        self.Conv_2 = Conv(1, 1, 5, padding=2, bias=False, dtype=dt, device=device)
        self.Conv_3 = _pw(1, feats - 2 * c3, dt, bias=True, device=device)
        self.Conv_4 = Conv(1, 1, 7, padding=3, bias=False, dtype=dt, device=device)
        self.Conv_5 = _pw(feats, feats, dt, device=device)
        self.Conv_6 = _dw(feats, dt, device=device)
        self.Conv_7 = _pw(feats, feats, dt, device=device)
        self.scale = nn.Parameter(torch.empty(1, device=device))

    def forward(self, x):
        dt, c3 = self.dtype, self.c3
        f3 = self.Conv_0(x)
        f5 = self.Conv_1(self.Conv_2(x))
        f7 = self.Conv_3(self.Conv_4(x))
        wf = mix_kernel(self.Conv_5, dt)
        fused = f3 @ wf[:c3] + f5 @ wf[c3 : 2 * c3] + f7 @ wf[2 * c3 :]
        enh = lrelu(self.Conv_7(dw_apply(self.Conv_6, fused, dt)))
        return fused + self.scale * enh


class MultiScaleLocal(nn.Module):
    """Channel-split local branch: head 1x1 folded through the mixing 1x1,
    depthwise 3x3 over the other 3/4 of the channels."""

    def __init__(self, feats: int, dt, device=None):
        super().__init__()
        c = feats // 4
        self.c, self.dtype = c, dt
        self.Conv_0 = _pw(c, c, dt, device=device)
        self.Conv_1 = _dw(feats - c, dt, device=device)
        self.Conv_2 = _pw(feats, feats, dt, device=device)

    def forward(self, x):
        c, dt = self.c, self.dtype
        rest = dw_apply(self.Conv_1, x[..., c:], dt)
        wh = mix_kernel(self.Conv_0, dt)
        wm = mix_kernel(self.Conv_2, dt)
        y = lrelu(x[..., :c].to(dt) @ (wh @ wm[:c]) + rest @ wm[c:])
        return y + x


class CrossScanSSM(nn.Module):
    """4-way cross-scan through one shared Mamba: K4 (permute + LayerNorm)
    -> Mamba (K1, K9b, K9c or the plain reference by ``scan_impl``) -> K5
    (un-permute + 1x1 mix + scaled residual)."""

    def __init__(self, feats: int, d_state: int, d_conv: int, expand: float, dt,
                 device=None, scan_impl: str = "pallas"):
        super().__init__()
        self.dtype = dt
        self.LayerNorm_0 = LayerNorm(feats, device=device)
        self.mamba = Mamba(feats, d_state, d_conv, expand, scan_impl=scan_impl, dtype=dt,
                           device=device)
        self.Conv_0 = _pw(feats, feats, dt, device=device)
        self.scale = nn.Parameter(torch.empty(1, device=device))

    def forward(self, x):
        ln = self.LayerNorm_0
        seq = cross_scan_gather(x, ln.weight, ln.bias)
        out = self.mamba(seq)
        w1 = mix_kernel(self.Conv_0, self.dtype).contiguous()
        return cross_scan_scatter(out, x, w1, self.scale)


def dropout(y: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each value with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate) in y's dtype; the keep mask is
    drawn from ``generator`` (on y's device)."""
    keep = 1.0 - rate
    mask = torch.rand(y.shape, generator=generator, device=y.device) < keep
    return torch.where(mask, y / trace.upload(keep, y.device, y.dtype), 0)


class LFVSSMBlock(nn.Module):
    """Pre-norm dual-branch block: local || cross-scan SSM -> 1x1 fuse ->
    ECA -> dropout 0.1 (train mode only) -> scaled residual."""

    DROPOUT = 0.1

    def __init__(self, feats: int, d_state: int, d_conv: int, expand: float, dt,
                 device=None, scan_impl: str = "pallas"):
        super().__init__()
        self.feats, self.dtype = feats, dt
        self.LayerNorm_0 = LayerNorm(feats, device=device)
        self.MultiScaleLocal_0 = MultiScaleLocal(feats, dt, device=device)
        self.CrossScanSSM_0 = CrossScanSSM(feats, d_state, d_conv, expand, dt, device=device,
                                           scan_impl=scan_impl)
        self.Conv_0 = _pw(2 * feats, feats, dt, device=device)
        self.ECA_0 = ECA(feats, dt, device=device)
        self.res_scale = nn.Parameter(torch.empty(1, device=device))

    def forward(self, x, generator: torch.Generator | None = None):
        c, dt = self.feats, self.dtype
        ln, msl = self.LayerNorm_0, self.MultiScaleLocal_0
        if ln_msl_takes(x, msl.c):
            # K7, the head 1x1 folded through the mix as in msl. At the TPU's
            # gate (it reads the float32 residual stream) x is cast to the
            # compute dtype before the LayerNorm, as JAX's K7 branch does;
            # elsewhere K7 takes x in float32, which is JAX's plain branch
            c4 = msl.c
            wh, wm = mix_kernel(msl.Conv_0, dt), mix_kernel(msl.Conv_2, dt)
            wk = msl.Conv_1.weight[:, 0].permute(1, 2, 0).to(dt)  # [3, 3, C-c4]
            xin = x.to(dt) if ln_msl_supported(x) else x.float()
            xn, local = ln_msl(xin.contiguous(), ln.weight, ln.bias,
                               (wh @ wm[:c4]).contiguous(), wm[c4:].contiguous(),
                               wk.contiguous())
        else:
            xn = layer_norm_fast(x, ln.weight, ln.bias).to(dt)
            local = msl(xn)
        with trace.span("model.block.ssm"):
            glob = self.CrossScanSSM_0(xn)
        wf = mix_kernel(self.Conv_0, dt)
        y = local.to(dt) @ wf[:c] + glob.to(dt) @ wf[c:]
        y = self.ECA_0(y)
        if self.training:
            if generator is None:
                raise ValueError("LFVSSMBlock in train mode needs a dropout generator")
            y = dropout(y, self.DROPOUT, generator)
        return x + self.res_scale * y


class WindowAttention(nn.Module):
    """8x8 window MHA with Swin relative-position bias, as one K6 launch.
    Only the fused branch (H, W multiples of the window) is ported."""

    def __init__(self, feats: int, heads: int = 4, window: int = 8, device=None):
        super().__init__()
        ws = window
        self.heads, self.window = heads, ws
        self.LayerNorm_0 = LayerNorm(feats, device=device)
        self.Dense_0 = nn.Linear(feats, 3 * feats, bias=False, device=device)
        self.Dense_1 = nn.Linear(feats, feats, bias=False, device=device)
        self.rel_pos_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2, heads, device=device))
        self.attn_scale = nn.Parameter(torch.empty(1, device=device))
        coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
        flat = coords.reshape(2, -1)
        rel = (flat[:, :, None] - flat[:, None, :] + ws - 1).transpose(1, 2, 0)
        self._rel_index = (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, heads, T = self.window, self.heads, self.window**2
        if h % ws or w % ws or c % heads:
            raise NotImplementedError(
                f"WindowAttention: only the fused branch (H, W multiples of {ws}) is "
                f"ported; got {tuple(x.shape)}"
            )
        idx = trace.upload(self._rel_index, x.device)
        bias = self.rel_pos_table[idx].reshape(T, T, heads)
        bias_big = bias.permute(0, 2, 1).reshape(T, heads * T).contiguous()
        ln = self.LayerNorm_0
        return window_mha_fused(
            x.contiguous(), self.Dense_0.weight.t().contiguous(),
            self.Dense_1.weight.t().contiguous(), ln.weight, ln.bias, bias_big,
            self.attn_scale, ws, heads, 1e-6,
        )


class SpatialAttention(nn.Module):
    """Two-dilation depthwise gate."""

    def __init__(self, c: int, dt, device=None):
        super().__init__()
        self.c, self.dtype = c, dt
        self.Conv_0 = _dw(c, dt, device=device)
        self.Conv_1 = _dw(c, dt, dilation=3, device=device)
        self.Conv_2 = _pw(2 * c, c, dt, device=device)
        self.Conv_3 = _pw(c, c, dt, bias=True, device=device)
        self.Conv_4 = _pw(2 * c, c, dt, device=device)
        self.scale = nn.Parameter(torch.empty(1, device=device))

    def forward(self, x):
        c, dt = self.c, self.dtype
        m1 = dw_apply(self.Conv_0, x, dt)
        m2 = dw_apply(self.Conv_1, x, dt)
        wg = mix_kernel(self.Conv_2, dt)
        gate = lrelu(m1 @ wg[:c] + m2 @ wg[c:])
        gate = torch.sigmoid(pw_apply(self.Conv_3, gate, dt))
        wp = mix_kernel(self.Conv_4, dt)
        proj = m1 @ wp[:c] + m2 @ wp[c:]
        return x + self.scale * proj * gate


class LSFL(nn.Module):
    """EPI structure learning: h/v dilated depthwise convs, angular gate,
    disparity (SE) modulation."""

    def __init__(self, c: int, ang: int, dt, device=None):
        super().__init__()
        self.c, self.dtype = c, dt
        self.Conv_0 = Conv(c, c, (1, 3), dilation=(1, ang), padding=(0, ang), groups=c,
                           bias=False, dtype=dt, device=device)
        self.Conv_1 = _pw(c, c, dt, device=device)
        self.Conv_2 = Conv(c, c, (3, 1), dilation=(ang, 1), padding=(ang, 0), groups=c,
                           bias=False, dtype=dt, device=device)
        self.Conv_3 = _pw(c, c, dt, device=device)
        self.Conv_4 = _pw(2 * c, c, dt, device=device)
        self.Conv_5 = _dw(c, dt, device=device)
        self.Conv_6 = _pw(2 * c, c, dt, device=device)
        self.Conv_7 = _pw(c, c // 4, dt, device=device)
        self.Conv_8 = _pw(c // 4, c, dt, device=device)
        self.scale = nn.Parameter(torch.empty(1, device=device))

    def forward(self, x):
        c, dt = self.c, self.dtype
        eh = pw_apply(self.Conv_1, lrelu(self.Conv_0(x)), dt)
        ev = pw_apply(self.Conv_3, lrelu(self.Conv_2(x)), dt)
        wg = mix_kernel(self.Conv_4, dt)
        gate = lrelu(eh @ wg[:c] + ev @ wg[c:])
        gate = torch.sigmoid(dw_apply(self.Conv_5, gate, dt))
        wp = mix_kernel(self.Conv_6, dt)
        epi = (eh @ wp[:c] + ev @ wp[c:]) * gate
        se = epi.mean(dim=(1, 2), keepdim=True)
        se = torch.sigmoid(self.Conv_8(lrelu(self.Conv_7(se))))
        return x + self.scale * (epi * se)


class ProgressiveFusion(nn.Module):
    """Weighted fusion of the block outputs in stages of 3."""

    def __init__(self, c: int, n_blocks: int, dt, device=None):
        super().__init__()
        ns = n_blocks // 3
        if 3 * ns != n_blocks:
            raise ValueError(f"ProgressiveFusion needs a multiple of 3 blocks, got {n_blocks}")
        self.c, self.ns, self.dtype = c, ns, dt
        for i in range(ns):
            setattr(self, f"proj_s{i + 1}", _pw(3 * c, c, dt, device=device))
        self.Conv_0 = _pw(ns * c, c, dt, device=device)
        self.Conv_1 = _dw(c, dt, device=device)
        self.Conv_2 = _pw(c, c, dt, device=device)
        self.stage_weights = nn.Parameter(torch.empty(ns, device=device))
        self.scale = nn.Parameter(torch.empty(1, device=device))

    def forward(self, blocks):
        c, ns, dt = self.c, self.ns, self.dtype
        stages = []
        for i in range(ns):
            w = mix_kernel(getattr(self, f"proj_s{i + 1}"), dt)
            stages.append(sum(blocks[3 * i + j].to(dt) @ w[j * c : (j + 1) * c]
                              for j in range(3)))
        wts = torch.softmax(self.stage_weights, dim=0)
        # float32 weight x bf16 stage -> float32, as the JAX promotion does
        weighted = sum(wts[i] * stages[i].float() for i in range(ns))
        wc = mix_kernel(self.Conv_0, dt)
        cross = lrelu(sum(stages[i] @ wc[i * c : (i + 1) * c] for i in range(ns)))
        cross = self.Conv_2(dw_apply(self.Conv_1, cross, dt))
        return weighted + self.scale * cross


def fold_out_conv(k3: torch.Tensor, r: int) -> torch.Tensor:
    """Fold a 3x3 HR conv [3, 3, C_in, 1] (HWIO) through a preceding r-fold
    pixel shuffle: returns the [3, 3, C_in*r*r, r*r] LR kernel with
    conv3x3(pixel_shuffle(z, r)) == pixel_shuffle(conv3x3_LR(z), r)."""
    kh, kw, cin, _ = k3.shape
    rr = r * r
    M = np.zeros((3, 3, rr, rr, kh, kw), np.float32)
    for py in range(r):
        for px in range(r):
            for dy in range(-(kh // 2), kh // 2 + 1):
                for dx in range(-(kw // 2), kw // 2 + 1):
                    u, v = py + dy, px + dx
                    M[u // r + 1, v // r + 1, (u % r) * r + (v % r), py * r + px,
                      dy + kh // 2, dx + kw // 2] = 1.0
    Mt = trace.upload(M, k3.device).to(k3.dtype)
    return torch.einsum("YXioab,abc->YXcio", Mt, k3[..., 0]).reshape(3, 3, cin * rr, rr)


def apply_folded_taps(z: torch.Tensor, kf: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Apply the folded [3, 3, C, rr] out-conv as one taps-stacked matmul
    with float32 accumulation, then 9 shifted slice-adds. Returns f32."""
    kh, kw, C, rr = kf.shape
    W36 = kf.permute(2, 0, 1, 3).reshape(C, kh * kw * rr)
    zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
    t = zp.float() @ W36.float()  # [B, H+2, W+2, 9*rr]
    Hh, Ww = z.shape[1], z.shape[2]
    out = bias.float()
    for ky in range(kh):
        for kx in range(kw):
            k = ky * kw + kx
            out = out + t[:, ky : ky + Hh, kx : kx + Ww, k * rr : (k + 1) * rr]
    return out


class HLFR(nn.Module):
    """Deep reconstruction head + pixel-shuffle upsampler; the final 3x3
    out-conv is folded through the last shuffle (``fold_out_conv``)."""

    def __init__(self, c: int, scale_factor: int, dt, device=None):
        super().__init__()
        self.c, self.dtype = c, dt
        self.stages = [2] * (scale_factor // 2) if scale_factor in (2, 4) else [scale_factor]
        for i in range(3):
            setattr(self, f"Conv_{2 * i}", _pw(c, c, dt, device=device))
            setattr(self, f"Conv_{2 * i + 1}", _dw(c, dt, device=device))
        self.Conv_6 = _dw(c, dt, device=device)
        self.Conv_7 = _pw(c, c // 8, dt, device=device)
        self.Conv_8 = _pw(c // 8, c, dt, device=device)
        self.ECA_0 = ECA(c, dt, reduction=16, device=device)
        self.Conv_9 = Conv(c, 1, 3, padding=1, dtype=dt, device=device)
        for si, r in enumerate(self.stages):
            setattr(self, f"Conv_{10 + 2 * si}", _dw(c, dt, device=device))
            setattr(self, f"Conv_{11 + 2 * si}", _pw(c, c * r * r, dt, device=device))
        self.out_scale = nn.Parameter(torch.empty(1, device=device))

    def forward(self, x):
        dt = self.dtype
        y = x
        for i in range(3):
            y = pw_apply(getattr(self, f"Conv_{2 * i}"),
                         dw_apply(getattr(self, f"Conv_{2 * i + 1}"), y, dt), dt)
            if i < 2:
                y = lrelu(y)
        edge = dw_apply(self.Conv_6, y.abs(), dt)
        edge = lrelu(pw_apply(self.Conv_7, edge, dt))
        edge = torch.sigmoid(pw_apply(self.Conv_8, edge, dt))
        y = self.ECA_0(y * edge + x)
        for si, r in enumerate(self.stages):
            y = lrelu(dw_apply(getattr(self, f"Conv_{10 + 2 * si}"), y, dt))
            wexp = mix_kernel(getattr(self, f"Conv_{11 + 2 * si}"), dt)
            if si == len(self.stages) - 1:
                k3 = self.Conv_9.weight.permute(2, 3, 1, 0).to(dt)  # HWIO
                kf = fold_out_conv(k3, r)
                out = hlfr_tail(y.to(dt), wexp, kf, self.Conv_9.bias.to(dt), 0.1)
                out = pixel_shuffle(out, r)
            else:
                y = lrelu(pixel_shuffle(y @ wexp, r))
        return out * self.out_scale


DEFAULT_PHASES = ((4, 0.25), (5, 0.35), (3, None))


@register_model("LFMambaX", loss=composite_v8_builder, whole_scene_ok=True)
class LFMambaX(nn.Module):
    """The flagship. Config overrides (``cfg.model_kwargs``): channels,
    d_state, d_conv, expand, use_macpi, phases, scan_impl ('pallas', 'gated',
    'fused' or 'assoc'; the parameter tree does not depend on it)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        c = cfg.mk("channels", 64)
        d_state = cfg.mk("d_state", 16)
        d_conv = cfg.mk("d_conv", 4)
        expand = cfg.mk("expand", 1.25)
        scan_impl = cfg.mk("scan_impl", "pallas")
        dt = getattr(torch, cfg.compute_dtype)
        self.cfg, self.dtype = cfg, dt
        self.phases = tuple(tuple(p) for p in cfg.mk("phases", DEFAULT_PHASES))
        nb = sum(n for n, _ in self.phases)
        if nb == 12:
            res_scales = ([0.15 + 0.025 * i for i in range(4)]
                          + [0.25 + 0.02 * i for i in range(5)]
                          + [0.35 + 0.025 * i for i in range(3)])
        else:
            res_scales = list(np.linspace(0.15, 0.425, nb))
        self.res_scales = res_scales  # res_scale init values (init_constants)
        self.IFE_0 = IFE(c, dt, device=device)
        for bi in range(nb):
            setattr(self, f"block_{bi}",
                    LFVSSMBlock(c, d_state, d_conv, expand, dt, device=device,
                                scan_impl=scan_impl))
        self.attn_scales = {}
        for phase, (_, attn_scale) in enumerate(self.phases):
            if attn_scale is not None:
                setattr(self, f"win_attn_{phase}", WindowAttention(c, device=device))
                self.attn_scales[f"win_attn_{phase}"] = attn_scale
        self.SpatialAttention_0 = SpatialAttention(c, dt, device=device)
        self.LSFL_0 = LSFL(c, cfg.angRes, dt, device=device)
        self.ProgressiveFusion_0 = ProgressiveFusion(c, nb, dt, device=device)
        self.HLFR_0 = HLFR(c, cfg.scale_factor, dt, device=device)

    def init_constants(self) -> dict[str, float]:
        """Parameters whose flax init is a constant (``bridge.init_params``):
        the modules' scales, the blocks' res_scales and the attention scales."""
        consts = {"IFE_0.scale": 0.2, "SpatialAttention_0.scale": 0.2, "LSFL_0.scale": 0.3,
                  "ProgressiveFusion_0.scale": 0.3, "ProgressiveFusion_0.stage_weights": 0.25,
                  "HLFR_0.out_scale": 0.5}
        for i, v in enumerate(self.res_scales):
            consts[f"block_{i}.res_scale"] = float(v)
            consts[f"block_{i}.CrossScanSSM_0.scale"] = 0.15
        consts.update({f"{m}.attn_scale": v for m, v in self.attn_scales.items()})
        return consts

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, H, W, 1] float32 SAI patches -> [B, H*s, W*s, 1] float32.
        In train mode the blocks' dropout draws from ``generator`` (flax's
        ``rngs={"dropout": key}``), which is then required."""
        a, s, dt = self.cfg.angRes, self.cfg.scale_factor, self.dtype
        with trace.span("model.input"):
            up = bicubic_up(x, s)
            h, w = x.shape[1], x.shape[2]
            macpi = self.cfg.mk("use_macpi", True) and h % a == 0 and w % a == 0
            xin = x
            if macpi:
                xin = sai_to_macpi(x.permute(0, 3, 1, 2), a).permute(0, 2, 3, 1)
            xin = xin.to(dt)
        with trace.span("model.ife"):
            shallow = self.IFE_0(xin)
        feat = shallow
        blocks = []
        bi = 0
        for phase, (n, attn_scale) in enumerate(self.phases):
            for _ in range(n):
                with trace.span("model.block"):
                    feat = getattr(self, f"block_{bi}")(feat, generator)
                blocks.append(feat)
                bi += 1
            if attn_scale is not None:
                with trace.span("model.window_attention"):
                    feat = getattr(self, f"win_attn_{phase}")(feat)
        with trace.span("model.fusion"):
            feat = self.LSFL_0(self.SpatialAttention_0(feat))
            staged = self.ProgressiveFusion_0(blocks)
            fused = feat + staged + shallow
        with trace.span("model.hlfr"):
            out = self.HLFR_0(fused)
        with trace.span("model.output"):
            if macpi:
                out = macpi_to_sai(out.permute(0, 3, 1, 2), a).permute(0, 2, 3, 1)
            return out.float() + up

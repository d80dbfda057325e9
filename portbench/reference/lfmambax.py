"""LFMambaX in plain float32 PyTorch: the benchmark's reference.

A light-field SR network over SAI mosaics [B, 5h, 5w, 1] -> [B, 20h, 20w, 1]
(NTIRE 2026 LF-SR Track 2 solution, the ``MyEfficientLFNet`` line):

    up      = bicubic(x, 4) over the whole mosaic
    x       -> MacPI layout
    shallow = IFE(x): 3x3 | 5x5->1x1 | 7x7->1x1 branches, 1x1 fuse, a
              depthwise-3x3 -> 1x1 -> lrelu enhancement, scaled
    12 LFVSSM blocks in phases of 4, 5 and 3, an 8x8 window attention
              after phases 0 and 1:
              LN -> [local: 1x1 on the first quarter of the channels and a
              depthwise 3x3 on the rest, mixed by a 1x1, lrelu, + LN out]
              || [cross-scan SSM: the map read in 4 orders (one per channel
              quarter), LN, one Mamba (in_proj, causal depthwise conv1d +
              SiLU, x_proj, dt = softplus(dt_low @ Wdt + b), selective
              scan + D skip, gated by SiLU(z), out_proj), read back, 1x1
              mix, + LN out scaled] -> 1x1 fuse -> ECA -> (dropout 0.1 in
              training) -> x + res_scale * y
    feat    = LSFL(SpatialAttention(feat)); staged = ProgressiveFusion of
              the 12 block outputs in stages of 3
    out     = HLFR(feat + staged + shallow): three (depthwise 3x3 -> 1x1)
              pairs, an edge gate, ECA, two (depthwise 3x3, 1x1 to 4C,
              pixel shuffle 2, lrelu) stages, a 3x3 conv to one channel
              (written here on the HR map; the program folds it through
              the last shuffle), x out_scale
    return  MacPI -> SAI of out, + up

Parameters are a dict of float32 tensors under the flax scope names the
program also uses; :func:`param_specs` lists them with their initialisers.
``q`` (``common.Prec``) rounds activations and weights where a model of the
configuration's compute dtype holds them in it: the identity for the
reference, a lower precision for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import (
    F32, Prec, bicubic, conv, dw, layer_norm, layer_norm_fast, lrelu, macpi_to_sai, mm,
    pixel_shuffle, pw, sai_to_macpi, selective_scan, softplus,
)

PHASES = ((4, 0.25), (5, 0.35), (3, None))


def widths(kw: dict) -> dict:
    """The configuration's widths, from its ``model_kwargs``."""
    c = kw.get("channels", 64)
    d_state = kw.get("d_state", 16)
    expand = kw.get("expand", 1.25)
    return {"C": c, "N": d_state, "K": kw.get("d_conv", 4), "Di": int(expand * c),
            "R": math.ceil(c / 16), "phases": tuple(tuple(p) for p in kw.get("phases", PHASES)),
            "heads": 4, "ws": 8}


def res_scales(nb: int) -> list[float]:
    if nb == 12:
        return ([0.15 + 0.025 * i for i in range(4)] + [0.25 + 0.02 * i for i in range(5)]
                + [0.35 + 0.025 * i for i in range(3)])
    return [float(v) for v in np.linspace(0.15, 0.425, nb)]


def param_specs(kw: dict, ang: int = 5, scale: int = 4) -> dict:
    """name -> (shape, init): init is "lecun" (truncated normal, variance
    1/fan_in), "rel_pos" (truncated normal, sd 0.02), "zeros", "ones",
    "A_log" (log 1..N on every row) or a float constant."""
    w = widths(kw)
    C, N, K, Di, R = w["C"], w["N"], w["K"], w["Di"], w["R"]
    c3, c4 = C // 3, C // 4
    out: dict = {}

    def conv_(name, o, i, kh, kw_=None, bias=False):
        out[f"{name}.weight"] = ((o, i, kh, kw_ or kh), "lecun")
        if bias:
            out[f"{name}.bias"] = ((o,), "zeros")

    def ln(name, c):
        out[f"{name}.weight"] = ((c,), "ones")
        out[f"{name}.bias"] = ((c,), "zeros")

    def eca(name, c, red):
        h = max(c // red, 16)
        conv_(f"{name}.Conv_0", h, c, 1, bias=True)
        conv_(f"{name}.Conv_1", c, h, 1, bias=True)

    conv_("IFE_0.Conv_0", c3, 1, 3, bias=True)
    conv_("IFE_0.Conv_1", c3, 1, 1, bias=True)
    conv_("IFE_0.Conv_2", 1, 1, 5)
    conv_("IFE_0.Conv_3", C - 2 * c3, 1, 1, bias=True)
    conv_("IFE_0.Conv_4", 1, 1, 7)
    conv_("IFE_0.Conv_5", C, C, 1)
    conv_("IFE_0.Conv_6", C, 1, 3)
    conv_("IFE_0.Conv_7", C, C, 1)
    out["IFE_0.scale"] = ((1,), 0.2)
    nb = sum(n for n, _ in w["phases"])
    for bi, rs in enumerate(res_scales(nb)):
        b = f"block_{bi}"
        ln(f"{b}.LayerNorm_0", C)
        conv_(f"{b}.MultiScaleLocal_0.Conv_0", c4, c4, 1)
        conv_(f"{b}.MultiScaleLocal_0.Conv_1", C - c4, 1, 3)
        conv_(f"{b}.MultiScaleLocal_0.Conv_2", C, C, 1)
        s = f"{b}.CrossScanSSM_0"
        ln(f"{s}.LayerNorm_0", C)
        m = f"{s}.mamba"
        out[f"{m}.in_proj.weight"] = ((2 * Di, C), "lecun")
        out[f"{m}.conv1d.weight"] = ((Di, 1, K), "lecun")
        out[f"{m}.conv1d.bias"] = ((Di,), "zeros")
        out[f"{m}.x_proj.weight"] = ((R + 2 * N, Di), "lecun")
        out[f"{m}.dt_proj.weight"] = ((Di, R), "lecun")
        out[f"{m}.dt_proj.bias"] = ((Di,), "zeros")
        out[f"{m}.A_log"] = ((Di, N), "A_log")
        out[f"{m}.D"] = ((Di,), "ones")
        out[f"{m}.out_proj.weight"] = ((C, Di), "lecun")
        conv_(f"{s}.Conv_0", C, C, 1)
        out[f"{s}.scale"] = ((1,), 0.15)
        conv_(f"{b}.Conv_0", C, 2 * C, 1)
        eca(f"{b}.ECA_0", C, 8)
        out[f"{b}.res_scale"] = ((1,), float(rs))
    for phase, (_, attn) in enumerate(w["phases"]):
        if attn is not None:
            a = f"win_attn_{phase}"
            ln(f"{a}.LayerNorm_0", C)
            out[f"{a}.Dense_0.weight"] = ((3 * C, C), "lecun")
            out[f"{a}.Dense_1.weight"] = ((C, C), "lecun")
            out[f"{a}.rel_pos_table"] = (((2 * w["ws"] - 1) ** 2, w["heads"]), "rel_pos")
            out[f"{a}.attn_scale"] = ((1,), float(attn))
    sa = "SpatialAttention_0"
    conv_(f"{sa}.Conv_0", C, 1, 3)
    conv_(f"{sa}.Conv_1", C, 1, 3)
    conv_(f"{sa}.Conv_2", C, 2 * C, 1)
    conv_(f"{sa}.Conv_3", C, C, 1, bias=True)
    conv_(f"{sa}.Conv_4", C, 2 * C, 1)
    out[f"{sa}.scale"] = ((1,), 0.2)
    ls = "LSFL_0"
    conv_(f"{ls}.Conv_0", C, 1, 1, 3)
    conv_(f"{ls}.Conv_1", C, C, 1)
    conv_(f"{ls}.Conv_2", C, 1, 3, 1)
    conv_(f"{ls}.Conv_3", C, C, 1)
    conv_(f"{ls}.Conv_4", C, 2 * C, 1)
    conv_(f"{ls}.Conv_5", C, 1, 3)
    conv_(f"{ls}.Conv_6", C, 2 * C, 1)
    conv_(f"{ls}.Conv_7", C // 4, C, 1)
    conv_(f"{ls}.Conv_8", C, C // 4, 1)
    out[f"{ls}.scale"] = ((1,), 0.3)
    pf, ns = "ProgressiveFusion_0", nb // 3
    for i in range(ns):
        conv_(f"{pf}.proj_s{i + 1}", C, 3 * C, 1)
    conv_(f"{pf}.Conv_0", C, ns * C, 1)
    conv_(f"{pf}.Conv_1", C, 1, 3)
    conv_(f"{pf}.Conv_2", C, C, 1)
    out[f"{pf}.stage_weights"] = ((ns,), 0.25)
    out[f"{pf}.scale"] = ((1,), 0.3)
    hl = "HLFR_0"
    for i in range(3):
        conv_(f"{hl}.Conv_{2 * i}", C, C, 1)
        conv_(f"{hl}.Conv_{2 * i + 1}", C, 1, 3)
    conv_(f"{hl}.Conv_6", C, 1, 3)
    conv_(f"{hl}.Conv_7", C // 8, C, 1)
    conv_(f"{hl}.Conv_8", C, C // 8, 1)
    eca(f"{hl}.ECA_0", C, 16)
    conv_(f"{hl}.Conv_9", 1, C, 3, bias=True)
    stages = [2] * (scale // 2) if scale in (2, 4) else [scale]
    for si, r in enumerate(stages):
        conv_(f"{hl}.Conv_{10 + 2 * si}", C, 1, 3)
        conv_(f"{hl}.Conv_{11 + 2 * si}", C * r * r, C, 1)
    out[f"{hl}.out_scale"] = ((1,), 0.5)
    return out


def _mix(p, name):
    """A 1x1 convolution's weight as a [C_in, C_out] matrix."""
    return p[f"{name}.weight"][:, :, 0, 0].t()


def _eca(q, p, name, y):
    s = y.mean(dim=(1, 2), keepdim=True)
    s = torch.relu(pw(q, s, p[f"{name}.Conv_0.weight"], p[f"{name}.Conv_0.bias"]))
    return y * torch.sigmoid(pw(q, s, p[f"{name}.Conv_1.weight"], p[f"{name}.Conv_1.bias"]))


def _ife(q, p, x):
    w = lambda n: p[f"IFE_0.{n}.weight"]
    b = lambda n: p[f"IFE_0.{n}.bias"]
    C = w("Conv_5").shape[0]
    c3 = C // 3
    f3 = conv(q, x, w("Conv_0"), b("Conv_0"), padding=1)
    f5 = pw(q, conv(q, x, w("Conv_2"), padding=2), w("Conv_1"), b("Conv_1"))
    f7 = pw(q, conv(q, x, w("Conv_4"), padding=3), w("Conv_3"), b("Conv_3"))
    wf = _mix(p, "IFE_0.Conv_5")
    fused = q(mm(q, f3, wf[:c3]) + mm(q, f5, wf[c3 : 2 * c3]))
    fused = q(fused + mm(q, f7, wf[2 * c3 :]))
    enh = lrelu(pw(q, dw(q, fused, w("Conv_6")), w("Conv_7")))
    return fused + p["IFE_0.scale"] * enh


def _cross_scan(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*W, C]: channel quarters read row-major,
    reversed row-major, column-major and reversed column-major."""
    b, h, w, c = x.shape
    g = c // 4
    return torch.cat([x[..., :g].reshape(b, h * w, g),
                      x[..., g : 2 * g].reshape(b, h * w, g).flip(1),
                      x[..., 2 * g : 3 * g].transpose(1, 2).reshape(b, h * w, g),
                      x[..., 3 * g :].transpose(1, 2).reshape(b, h * w, c - 3 * g).flip(1)],
                     dim=-1)


def _cross_merge(seq: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = seq.shape
    g = c // 4
    return torch.cat([seq[..., :g].reshape(b, h, w, g),
                      seq[..., g : 2 * g].flip(1).reshape(b, h, w, g),
                      seq[..., 2 * g : 3 * g].reshape(b, w, h, g).transpose(1, 2),
                      seq[..., 3 * g :].flip(1).reshape(b, w, h, c - 3 * g).transpose(1, 2)],
                     dim=-1)


def _mamba(q, p, m, seq, remat):
    Di = p[f"{m}.D"].shape[0]
    N = p[f"{m}.A_log"].shape[1]
    R = p[f"{m}.dt_proj.weight"].shape[1]
    xz = mm(q, seq, p[f"{m}.in_proj.weight"].t())
    xs, z = xz[..., :Di], xz[..., Di:]
    wconv = q(p[f"{m}.conv1d.weight"][:, 0, :].t())  # [K, Di]
    K, L = wconv.shape[0], xs.shape[1]
    xp = torch.nn.functional.pad(xs, (0, 0, K - 1, 0))
    acc = q(xp[:, 0:L] * wconv[0])
    for k in range(1, K):
        acc = q(acc + q(xp[:, k : k + L] * wconv[k]))
    xc = q(torch.nn.functional.silu(q(q(p[f"{m}.conv1d.bias"]) + acc)))
    dbc = mm(q, xc, p[f"{m}.x_proj.weight"].t())
    delta = softplus(dbc[..., :R] @ p[f"{m}.dt_proj.weight"].t() + p[f"{m}.dt_proj.bias"])
    A = -torch.exp(p[f"{m}.A_log"])
    y = q(selective_scan(xc, delta, A, dbc[..., R : R + N], dbc[..., R + N :], p[f"{m}.D"],
                         remat=remat))
    y = q(y * torch.nn.functional.silu(z))
    return mm(q, y, p[f"{m}.out_proj.weight"].t())


def k7_rounds_input(x: torch.Tensor) -> bool:
    """Where the configuration's block LayerNorm reads its input already
    held in the compute precision: a square map of at least 4 x 160 x 160
    pixels whose side is a multiple of 8 (else it reads float32)."""
    b, h, w, c = x.shape
    return h == w and h >= 8 and b * h * w >= 4 * 160 * 160 and h % 8 == 0 and c % 32 == 0


def dropout_masks(gen: torch.Generator, shape, kw: dict) -> list:
    """The keep masks of every block's dropout (rate 0.1) for a forward on
    maps of ``shape`` [B, H, W, C], drawn from ``gen`` block by block in
    order, as training draws them."""
    nb = sum(n for n, _ in widths(kw)["phases"])
    return [torch.rand(tuple(shape), generator=gen, device=gen.device) < 0.9 for _ in range(nb)]


def _block(q, p, b, x, keep_mask, remat):
    C = x.shape[-1]
    c4 = C // 4
    ln = f"{b}.LayerNorm_0"
    xin = q(x) if k7_rounds_input(x) else x
    xn = q(layer_norm_fast(xin, p[f"{ln}.weight"], p[f"{ln}.bias"]))
    # local branch: the head 1x1 folded through the mix, as the model defines it
    msl = f"{b}.MultiScaleLocal_0"
    wh, wm = q(_mix(p, f"{msl}.Conv_0")), q(_mix(p, f"{msl}.Conv_2"))
    whm = mm(q, wh, wm[:c4])
    rest = dw(q, xn[..., c4:], p[f"{msl}.Conv_1.weight"])
    local = q(lrelu(q(mm(q, xn[..., :c4], whm) + mm(q, rest, wm[c4:]))))
    local = q(local + xn)
    s = f"{b}.CrossScanSSM_0"
    seq = q(layer_norm_fast(_cross_scan(xn), p[f"{s}.LayerNorm_0.weight"],
                            p[f"{s}.LayerNorm_0.bias"]))
    out = _mamba(q, p, f"{s}.mamba", seq, remat)
    y = mm(q, _cross_merge(out, x.shape[1], x.shape[2]), _mix(p, f"{s}.Conv_0"))
    glob = q(xn + p[f"{s}.scale"] * y)
    wf = _mix(p, f"{b}.Conv_0")
    y = q(mm(q, local, wf[:C]) + mm(q, glob, wf[C:]))
    y = q(_eca(q, p, f"{b}.ECA_0", y))
    if keep_mask is not None:
        y = torch.where(keep_mask, q(y / 0.9), 0.0)
    return x + p[f"{b}.res_scale"] * y


def _window_attention(p, a, x, heads: int = 4, ws: int = 8):
    """8x8 window MHA with a Swin relative-position bias, float32 (the
    configuration computes it in float32): LN (two-pass) -> qkv -> per-head
    softmax(q k^T / sqrt(hd) + bias) v -> out-proj -> x + attn_scale * out."""
    B, H, W, C = x.shape
    T, hd = ws * ws, C // heads
    xw = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, T, C)
    t = layer_norm(xw, p[f"{a}.LayerNorm_0.weight"], p[f"{a}.LayerNorm_0.bias"])
    qkv = t @ p[f"{a}.Dense_0.weight"].t()
    qh, kh, vh = (z.reshape(-1, T, heads, hd) for z in qkv.split(C, dim=-1))
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :] + ws - 1).transpose(1, 2, 0)
    idx = torch.as_tensor((rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1), device=x.device)
    bias = p[f"{a}.rel_pos_table"][idx].reshape(T, T, heads).permute(2, 0, 1)
    s = torch.einsum("wihd,wjhd->whij", qh / math.sqrt(hd), kh) + bias
    o = torch.einsum("whij,wjhd->wihd", torch.softmax(s, dim=-1), vh).reshape(-1, T, C)
    o = (o @ p[f"{a}.Dense_1.weight"].t()) * p[f"{a}.attn_scale"]
    o = o.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    return x + o


def _spatial_attention(q, p, x):
    sa = "SpatialAttention_0"
    C = x.shape[-1]
    m1 = dw(q, x, p[f"{sa}.Conv_0.weight"])
    m2 = dw(q, x, p[f"{sa}.Conv_1.weight"], dilation=3)
    wg, wp = _mix(p, f"{sa}.Conv_2"), _mix(p, f"{sa}.Conv_4")
    gate = lrelu(q(mm(q, m1, wg[:C]) + mm(q, m2, wg[C:])))
    gate = torch.sigmoid(pw(q, gate, p[f"{sa}.Conv_3.weight"], p[f"{sa}.Conv_3.bias"]))
    proj = q(mm(q, m1, wp[:C]) + mm(q, m2, wp[C:]))
    return x + p[f"{sa}.scale"] * proj * q(gate)


def _lsfl(q, p, x, ang):
    ls = "LSFL_0"
    C = x.shape[-1]
    w = lambda n: p[f"{ls}.{n}.weight"]
    eh = pw(q, lrelu(conv(q, x, w("Conv_0"), padding=(0, ang), dilation=(1, ang), groups=C)),
            w("Conv_1"))
    ev = pw(q, lrelu(conv(q, x, w("Conv_2"), padding=(ang, 0), dilation=(ang, 1), groups=C)),
            w("Conv_3"))
    wg, wp = _mix(p, f"{ls}.Conv_4"), _mix(p, f"{ls}.Conv_6")
    gate = lrelu(q(mm(q, eh, wg[:C]) + mm(q, ev, wg[C:])))
    gate = q(torch.sigmoid(dw(q, gate, w("Conv_5"))))
    epi = q(q(mm(q, eh, wp[:C]) + mm(q, ev, wp[C:])) * gate)
    se = epi.mean(dim=(1, 2), keepdim=True)
    se = q(torch.sigmoid(pw(q, lrelu(pw(q, se, w("Conv_7"))), w("Conv_8"))))
    return x + p[f"{ls}.scale"] * q(epi * se)


def _fusion(q, p, blocks):
    pf = "ProgressiveFusion_0"
    C, ns = blocks[0].shape[-1], len(blocks) // 3
    stages = []
    for i in range(ns):
        w = _mix(p, f"{pf}.proj_s{i + 1}")
        acc = mm(q, blocks[3 * i], w[:C])
        for j in (1, 2):
            acc = q(acc + mm(q, blocks[3 * i + j], w[j * C : (j + 1) * C]))
        stages.append(acc)
    wts = torch.softmax(p[f"{pf}.stage_weights"], dim=0)
    weighted = sum(wts[i] * stages[i] for i in range(ns))
    wc = _mix(p, f"{pf}.Conv_0")
    cross = mm(q, stages[0], wc[:C])
    for i in range(1, ns):
        cross = q(cross + mm(q, stages[i], wc[i * C : (i + 1) * C]))
    cross = pw(q, dw(q, lrelu(cross), p[f"{pf}.Conv_1.weight"]), p[f"{pf}.Conv_2.weight"])
    return weighted + p[f"{pf}.scale"] * cross


def _hlfr(q, p, x, scale):
    hl = "HLFR_0"
    w = lambda n: p[f"{hl}.{n}.weight"]
    y = x
    for i in range(3):
        y = pw(q, dw(q, y, w(f"Conv_{2 * i + 1}")), w(f"Conv_{2 * i}"))
        if i < 2:
            y = lrelu(y)
    edge = dw(q, y.abs(), w("Conv_6"))
    edge = lrelu(pw(q, edge, w("Conv_7")))
    edge = q(torch.sigmoid(pw(q, edge, w("Conv_8"))))
    y = _eca(q, p, f"{hl}.ECA_0", q(y * edge) + x)
    stages = [2] * (scale // 2) if scale in (2, 4) else [scale]
    for si, r in enumerate(stages):
        y = lrelu(dw(q, y, w(f"Conv_{10 + 2 * si}")))
        y = q(lrelu(pixel_shuffle(mm(q, y, _mix(p, f"{hl}.Conv_{11 + 2 * si}")), r)))
    # the last 3x3 conv on the HR map, accumulated in float32 from the
    # compute-precision map and kernel
    out = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), q(w("Conv_9")), padding=1)
    out = out.permute(0, 2, 3, 1) + q(p[f"{hl}.Conv_9.bias"])
    return out * p[f"{hl}.out_scale"]


def forward(p: dict, x: torch.Tensor, kw: dict, ang: int = 5, scale: int = 4,
            q: Prec = F32, dropout: list | None = None,
            remat: bool = False) -> torch.Tensor:
    """x [B, A*h, A*w, 1] float32 LR SAI mosaics -> SR [B, A*h*s, A*w*s, 1].
    ``dropout``: the blocks' keep masks (training: :func:`dropout_masks`),
    or None; ``remat`` checkpoints the scans (training)."""
    phases = widths(kw)["phases"]
    up = bicubic(x.permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    macpi = kw.get("use_macpi", True) and h % ang == 0 and w % ang == 0
    xin = sai_to_macpi(x[..., 0], ang)[..., None] if macpi else x
    shallow = _ife(q, p, q(xin))
    feat, blocks, bi = shallow, [], 0
    for phase, (n, attn) in enumerate(phases):
        for _ in range(n):
            feat = _block(q, p, f"block_{bi}", feat, None if dropout is None else dropout[bi],
                          remat)
            blocks.append(feat)
            bi += 1
        if attn is not None:
            feat = _window_attention(p, f"win_attn_{phase}", feat)
    feat = _lsfl(q, p, _spatial_attention(q, p, feat), ang)
    out = _hlfr(q, p, feat + _fusion(q, p, blocks) + shallow, scale)
    if macpi:
        out = macpi_to_sai(out[..., 0], ang)[..., None]
    return out + up

"""LF-DET in plain float32 PyTorch: the benchmark's reference.

A light-field SR network over SAI mosaics [B, 5h, 5w, 1] -> [B, 20h, 20w, 1]
(Cong, Sheng, Yang, Cui, Chen, "Exploiting Spatial and Angular Correlations
With Deep Efficient Transformers for Light Field Image Super-Resolution",
IEEE TMM 2023; BasicLFSR ``model/SR/LF_DET.py``):

    up    = per-view bicubic(x, 4)
    y     = per-view conv 3x3 1->C; feat = y + three (conv 3x3 + lrelu 0.1)
    4 mix blocks of
      spa x2 : each view's h x w pixels are tokens; LN -> attention whose
               keys and values come from a 2x2 stride-2 conv (+ bias) of the
               tokens and a LayerNorm (4 heads), residual; LN -> Mix-FFN
               (Dense C -> 4C, 3x3 depthwise conv + bias, GELU (tanh form),
               Dense 4C -> C), residual
      ang    : the MacPI image (each pixel's 5x5 views as a macro-pixel) cut
               into ws x ws windows, ws = 5, 10, 15, every ws and one more
               window ending at each edge where ws does not divide it; the
               same block (keys and values from the tokens themselves) over
               each window's tokens; the windows put back, the overlaps
               averaged; the three branches fused by a 1x1 conv (+ bias)
               and a softmax over them
    MLA   : top-down: the running sum of the blocks' outputs, deepest
            first, through conv 3x3 C->C, C->C/2, C/2->C/2 (each + lrelu)
            at every level; the levels concatenated, shallowest first
    out   = 1x1 conv 2C -> 16C, pixel shuffle 4, lrelu 0.1, conv 3x3 -> 1
    return out + up

Every Dense carries a bias; LayerNorms take the variance as E[x^2] -
E[x]^2 (eps 1e-6), the form the models were trained with; attention is
scaled by 1/sqrt(16). The windows are cut and put back by explicit loops
over their starts (rows of windows, then columns), the overlap average
summed in float32. DropPath acts in training only.

Parameters are a dict of float32 tensors under the names the program also
uses; :func:`param_specs` lists them with their initialisers. ``q``
(``common.Prec``) rounds activations and weights where a model of the
configuration's compute dtype holds them in it: the identity for the
reference, a lower precision for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    F32, Prec, bicubic, conv, layer_norm_fast, lrelu, mm, pixel_shuffle, pw, sai_to_macpi,
    sai_to_views, macpi_to_sai, views_to_sai,
)

HEADS = 4
MLP = 4
SR = 2
SCALES = (1, 2, 3)


def widths(kw: dict) -> dict:
    return {"C": kw.get("channels", 64), "depth": kw.get("depth", 4)}


def param_specs(kw: dict, ang: int = 5, scale: int = 4) -> dict:
    """name -> (shape, init): "lecun" (truncated normal, variance 1/fan_in),
    "zeros" or "ones"."""
    w = widths(kw)
    C, depth = w["C"], w["depth"]
    out: dict = {}

    def dense(name, o, i):
        out[f"{name}.weight"] = ((o, i), "lecun")
        out[f"{name}.bias"] = ((o,), "zeros")

    def ln(name, d):
        out[f"{name}.weight"] = ((d,), "ones")
        out[f"{name}.bias"] = ((d,), "zeros")

    def block(name, sr):
        ln(f"{name}.LayerNorm_0", C)
        a = f"{name}._Attention_0"
        dense(f"{a}.Dense_0", C, C)
        if sr > 1:
            out[f"{a}.Conv_0.weight"] = ((C, C, sr, sr), "lecun")
            out[f"{a}.Conv_0.bias"] = ((C,), "zeros")
            ln(f"{a}.LayerNorm_0", C)
        dense(f"{a}.Dense_1", 2 * C, C)
        dense(f"{a}.Dense_2", C, C)
        ln(f"{name}.LayerNorm_1", C)
        m = f"{name}._Mlp_0"
        dense(f"{m}.Dense_0", MLP * C, C)
        out[f"{m}.Conv_0.weight"] = ((MLP * C, 1, 3, 3), "lecun")
        out[f"{m}.Conv_0.bias"] = ((MLP * C,), "zeros")
        dense(f"{m}.Dense_1", C, MLP * C)

    out["Conv_0.weight"] = ((C, 1, 3, 3), "lecun")
    for j in (1, 2, 3):
        out[f"Conv_{j}.weight"] = ((C, C, 3, 3), "lecun")
    for i in range(depth):
        mb = f"_MixBlock_{i}"
        for j in range(2):
            block(f"{mb}._Block_{j}", SR)
        for m in range(len(SCALES)):
            block(f"{mb}._AngularWindows_{m}._Block_0", 1)
        out[f"{mb}.Conv_0.weight"] = ((len(SCALES), len(SCALES) * C, 1, 1), "lecun")
        out[f"{mb}.Conv_0.bias"] = ((len(SCALES),), "zeros")
    for lvl in range(depth):
        n = 4 + 3 * lvl
        out[f"Conv_{n}.weight"] = ((C, C, 3, 3), "lecun")
        out[f"Conv_{n + 1}.weight"] = ((C // 2, C, 3, 3), "lecun")
        out[f"Conv_{n + 2}.weight"] = ((C // 2, C // 2, 3, 3), "lecun")
    n = 4 + 3 * depth
    out[f"Conv_{n}.weight"] = ((C * scale * scale, depth * (C // 2), 1, 1), "lecun")
    out[f"Conv_{n + 1}.weight"] = ((1, C, 3, 3), "lecun")
    return out


def _dense(q, p, name, x):
    return q(mm(q, x, p[f"{name}.weight"].t()) + q(p[f"{name}.bias"]))


def _ln(q, p, name, x):
    return q(layer_norm_fast(x, p[f"{name}.weight"], p[f"{name}.bias"]))


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh((2.0 / torch.pi) ** 0.5 * (x + 0.044715 * x**3)))


def _attention(q, p, name, x, h, w, sr):
    """Tokens x [B, h*w, C] attend to keys and values of their own (sr 1)
    or of the sr x sr stride-sr conv of their h x w grid and a LayerNorm."""
    B, N, C = x.shape
    hd = C // HEADS
    qq = _dense(q, p, f"{name}.Dense_0", x)
    src = x
    if sr > 1:
        grid = q(x).reshape(B, h, w, C).permute(0, 3, 1, 2)
        red = F.conv2d(grid, q(p[f"{name}.Conv_0.weight"]), stride=sr)
        red = q(q(red.flatten(2).transpose(1, 2)) + q(p[f"{name}.Conv_0.bias"]))
        src = _ln(q, p, f"{name}.LayerNorm_0", red)
    kv = _dense(q, p, f"{name}.Dense_1", src)
    k, v = kv[..., :C], kv[..., C:]
    split = lambda t: t.reshape(B, t.shape[1], HEADS, hd)
    s = torch.einsum("bihd,bjhd->bhij", split(qq) / hd**0.5, split(k))
    o = torch.einsum("bhij,bjhd->bihd", torch.softmax(s, dim=-1), split(v))
    return _dense(q, p, f"{name}.Dense_2", q(o.reshape(B, N, C)))


def _mlp(q, p, name, x, h, w):
    B, N, _ = x.shape
    y = _dense(q, p, f"{name}.Dense_0", x)
    hid = y.shape[-1]
    g = conv(q, y.reshape(B, h, w, hid), p[f"{name}.Conv_0.weight"], p[f"{name}.Conv_0.bias"],
             padding=1, groups=hid)
    return _dense(q, p, f"{name}.Dense_1", q(_gelu(g.reshape(B, N, hid))))


def _block(q, p, name, x, h, w, sr):
    x = q(x + _attention(q, p, f"{name}._Attention_0", _ln(q, p, f"{name}.LayerNorm_0", x),
                         h, w, sr))
    return q(x + _mlp(q, p, f"{name}._Mlp_0", _ln(q, p, f"{name}.LayerNorm_1", x), h, w))


def starts(extent: int, ws: int) -> list:
    """Every ws, and one more window ending at the edge where ws does not
    divide ``extent``."""
    s = list(range(0, extent - ws + 1, ws))
    return s if s[-1] + ws == extent else s + [extent - ws]


def _windows(q, p, name, macpi, ws):
    """One angular branch over the MacPI map [B, H, W, C]."""
    B, H, W, C = macpi.shape
    sh, sw = starts(H, ws), starts(W, ws)
    rows = torch.stack([macpi[:, i : i + ws] for i in sh], 1)  # [B, nh, ws, W, C]
    wins = torch.stack([rows[:, :, :, j : j + ws] for j in sw], 2)  # [B, nh, nw, ws, ws, C]
    toks = _block(q, p, f"{name}._Block_0", wins.reshape(-1, ws * ws, C), ws, ws, 1)
    wins = toks.reshape(B, len(sh), len(sw), ws, ws, C)
    rows = torch.zeros(B, len(sh), ws, W, C, device=macpi.device)
    for n, j in enumerate(sw):
        rows[:, :, :, j : j + ws] += wins[:, :, n]
    out = torch.zeros(B, H, W, C, device=macpi.device)
    cnt = torch.zeros(1, H, W, 1, device=macpi.device)
    for n, i in enumerate(sh):
        out[:, i : i + ws] += rows[:, n]
        for j in sw:
            cnt[:, i : i + ws, j : j + ws] += 1.0
    return q(out / cnt)


def _mix(q, p, name, views, ang):
    """views [B, A, A, h, w, C] -> the same."""
    b, _, _, h, w, C = views.shape
    tok = views.reshape(b * ang * ang, h * w, C)
    for j in range(2):
        tok = _block(q, p, f"{name}._Block_{j}", tok, h, w, SR)
    grid = tok.reshape(b, ang, ang, h, w, C).permute(0, 5, 1, 2, 3, 4)  # [B, C, A, A, h, w]
    macpi = sai_to_macpi(views_to_sai(grid), ang).permute(0, 2, 3, 1)  # [B, hA, wA, C]
    branches = [_windows(q, p, f"{name}._AngularWindows_{m}", macpi, s * ang)
                for m, s in enumerate(SCALES)]
    attn = pw(q, torch.cat(branches, -1), p[f"{name}.Conv_0.weight"], p[f"{name}.Conv_0.bias"])
    attn = q(torch.softmax(attn, dim=-1))
    fused = q(attn[..., 0:1] * branches[0])
    for m in range(1, len(branches)):
        fused = q(fused + q(attn[..., m : m + 1] * branches[m]))
    back = sai_to_views(macpi_to_sai(fused.permute(0, 3, 1, 2), ang), ang)  # [B, C, A, A, h, w]
    return back.permute(0, 2, 3, 4, 5, 1)


def forward(p: dict, x: torch.Tensor, kw: dict, ang: int = 5, scale: int = 4,
            q: Prec = F32) -> torch.Tensor:
    """x [B, A*h, A*w, 1] float32 LR SAI mosaics -> SR [B, A*h*s, A*w*s, 1]."""
    w_ = widths(kw)
    C, depth = w_["C"], w_["depth"]
    v = sai_to_views(x[..., 0], ang)  # [B, A, A, h, w]
    b, _, _, h, w = v.shape
    n = ang * ang
    up = bicubic(v.reshape(b * n, 1, h, w), scale).reshape(b, ang, ang, h * scale, w * scale)
    up = views_to_sai(up)[..., None]

    y0 = conv(q, v.reshape(b * n, h, w, 1), p["Conv_0.weight"], padding=1)
    y = y0
    for j in (1, 2, 3):
        y = q(lrelu(conv(q, y, p[f"Conv_{j}.weight"], padding=1)))
    feat = q(y + y0).reshape(b, ang, ang, h, w, C)
    hier = []
    for i in range(depth):
        feat = _mix(q, p, f"_MixBlock_{i}", feat, ang)
        hier.append(feat)
    fused, acc = [], None
    for lvl, f in enumerate(reversed(hier)):
        acc = f if acc is None else q(acc + f)
        g = acc.reshape(b * n, h, w, C)
        for j in range(3):
            g = q(lrelu(conv(q, g, p[f"Conv_{4 + 3 * lvl + j}.weight"], padding=1)))
        fused.append(g)
    agg = torch.cat(fused[::-1], -1)
    out = pw(q, agg, p[f"Conv_{4 + 3 * depth}.weight"])
    out = q(lrelu(pixel_shuffle(out, scale)))
    out = conv(q, out, p[f"Conv_{5 + 3 * depth}.weight"], padding=1)
    sr = views_to_sai(out.reshape(b, ang, ang, h * scale, w * scale))[..., None]
    return sr + up

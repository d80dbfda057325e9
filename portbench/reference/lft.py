"""LFT (Light Field Transformer) in plain float32 PyTorch: the benchmark's
reference.

A light-field SR network over SAI mosaics [B, 5h, 5w, 1] -> [B, 20h, 20w, 1]
(Liang et al., "Light Field Image Super-Resolution with Transformers",
IEEE SPL 2022; BasicLFSR ``model/SR/LFT.py``):

    up    = per-view bicubic(x, 4)
    y     = per-view conv 3x3 1->C, then y + three (conv 3x3 + lrelu 0.2)
    4 blocks of
      ang : each LR pixel's 25 views are the tokens (dim C); attention
            with 8 heads: LN(tok + code) -> q, k; tok -> v (no biases);
            softmax(q k^T / sqrt(hd)) v -> out-proj, residual; LN -> Dense
            2C -> relu -> Dense C, residual
      spa : each view's h x w pixels are the tokens, embedded from their
            zero-padded 3x3 neighbourhoods to dim 2C; the same attention
            block with every token attending to its 5 x 5 neighbours
            inside the view; Dense 2C -> C
    y     = y + (y after the stem)
    out   = 1x1 conv C -> 16C, pixel shuffle 4, lrelu 0.2, conv 3x3 -> 1
    return out + up

The codes are sinusoidal: the angular one over the 25 views (dim C), the
spatial one the mean of a row's and a column's code (dim C), embedded by
the spatial block's own 3x3 embedding; both are added to queries and keys
only. The banded attention is a dense softmax over each query's window,
the window's keys and values gathered by index, the slots outside the view
masked out.

Departures from the paper's code, as the port and the JAX package run it:
the codes are computed per call and passed as arguments, not injected as
module attributes (LFT.py:75-88); the LayerNorms take the variance as
E[x^2] - E[x]^2 (eps 1e-6), the form the models were trained with; the
projections carry no bias.

Parameters are a dict of float32 tensors under the names the program also
uses; :func:`param_specs` lists them with their initialisers. ``q``
(``common.Prec``) rounds activations and weights where a model of the
configuration's compute dtype holds them in it: the identity for the
reference, a lower precision for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.common import (
    F32, Prec, bicubic, conv, layer_norm_fast, lrelu, mm, pixel_shuffle, pw, sai_to_views,
    views_to_sai,
)

HEADS = 8
WINDOW = 5


def widths(kw: dict) -> dict:
    return {"C": kw.get("channels", 64), "blocks": kw.get("n_blocks", 4)}


def param_specs(kw: dict, ang: int = 5, scale: int = 4) -> dict:
    """name -> (shape, init): "lecun" (truncated normal, variance 1/fan_in),
    "zeros" or "ones"."""
    w = widths(kw)
    C = w["C"]
    out: dict = {}

    def lin(name, o, i):
        out[f"{name}.weight"] = ((o, i), "lecun")

    def mha(name, d):
        out[f"{name}.LayerNorm_0.weight"] = ((d,), "ones")
        out[f"{name}.LayerNorm_0.bias"] = ((d,), "zeros")
        for j in range(4):
            lin(f"{name}.Dense_{j}", d, d)
        out[f"{name}.LayerNorm_1.weight"] = ((d,), "ones")
        out[f"{name}.LayerNorm_1.bias"] = ((d,), "zeros")
        lin(f"{name}.Dense_4", 2 * d, d)
        lin(f"{name}.Dense_5", d, 2 * d)

    out["Conv_0.weight"] = ((C, 1, 3, 3), "lecun")
    for j in range(3):
        out[f"_ViewConv3Act_0.Conv_{j}.weight"] = ((C, C, 3, 3), "lecun")
    for i in range(w["blocks"]):
        mha(f"_AngTrans_{i}._MHA_0", C)
        lin(f"_SpaTrans_{i}.embed", 2 * C, 9 * C)
        mha(f"_SpaTrans_{i}._MHA_0", 2 * C)
        lin(f"_SpaTrans_{i}.Dense_0", C, 2 * C)
    out["Conv_1.weight"] = ((C * scale * scale, C, 1, 1), "lecun")
    out["Conv_2.weight"] = ((1, C, 3, 3), "lecun")
    return out


def sincos(length: int, dim: int) -> np.ndarray:
    """A sinusoidal code [length, dim]: angle pos / 10000^(2 floor(i/2) / dim);
    the even columns' sines, then the odd columns' cosines."""
    i = np.arange(dim, dtype=np.float64)
    ang = np.arange(length, dtype=np.float64)[:, None] / 10000.0 ** (2 * (i // 2) / dim)
    return np.concatenate([np.sin(ang[:, 0::2]), np.cos(ang[:, 1::2])], axis=1)


def _ln(q, p, name, x):
    return q(layer_norm_fast(x, p[f"{name}.weight"], p[f"{name}.bias"]))


def _lin(q, p, name, x):
    return mm(q, x, p[f"{name}.weight"].t())


def _full(qh, kh, vh):
    """Every token attends to every token: [B, L, H, hd] -> [B, L, H, hd]."""
    s = torch.einsum("bihd,bjhd->bhij", qh, kh)
    return torch.einsum("bhij,bjhd->bihd", torch.softmax(s, dim=-1), vh)


def _banded(h: int, w: int):
    """The attention of :func:`_block` over an h x w grid: each token's
    window slots gathered by index, the slots outside the grid masked."""
    r = WINDOW // 2
    dy, dx = np.meshgrid(np.arange(-r, WINDOW - r), np.arange(-r, WINDOW - r), indexing="ij")
    ny = np.arange(h)[:, None, None] + dy.reshape(-1)[None, None, :]
    nx = np.arange(w)[None, :, None] + dx.reshape(-1)[None, None, :]
    inside = ((ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)).reshape(h * w, -1)
    index = (np.clip(ny, 0, h - 1) * w + np.clip(nx, 0, w - 1)).reshape(h * w, -1)

    def attend(qh, kh, vh):
        dev = qh.device
        idx = torch.as_tensor(index, device=dev)
        ok = torch.as_tensor(inside, device=dev)
        kg, vg = kh[:, idx], vh[:, idx]  # [B, L, slots, H, hd]
        s = torch.einsum("blhd,blkhd->blhk", qh, kg)
        s = s.masked_fill(~ok[None, :, None, :], float("-inf"))
        return torch.einsum("blhk,blkhd->blhd", torch.softmax(s, dim=-1), vg)

    return attend


def _block(q, p, name, tok, pe, attend, q_sum):
    """Attention + FFN over tokens [B, L, d]; the code ``pe`` goes to the
    queries and keys only, the sum tok + pe held at ``q_sum`` (float32 for
    the angular code, which is float32; the compute precision for the
    embedded spatial one)."""
    B, L, d = tok.shape
    m = f"{name}._MHA_0"
    tn = _ln(q, p, f"{m}.LayerNorm_0", q_sum(tok + pe))
    split = lambda t: t.reshape(B, L, HEADS, d // HEADS)
    qh = split(_lin(q, p, f"{m}.Dense_0", tn)) / (d // HEADS) ** 0.5
    kh, vh = split(_lin(q, p, f"{m}.Dense_1", tn)), split(_lin(q, p, f"{m}.Dense_2", tok))
    o = q(attend(qh, kh, vh).reshape(B, L, d))
    tok = q(tok + _lin(q, p, f"{m}.Dense_3", o))
    f = _lin(q, p, f"{m}.Dense_5", torch.relu(_lin(q, p, f"{m}.Dense_4",
                                                   _ln(q, p, f"{m}.LayerNorm_1", tok))))
    return q(tok + f)


def _unfold3(x):
    """[B, h, w, C] -> [B, h*w, 9C]: each pixel's zero-padded 3x3
    neighbourhood, (dy, dx, c) order."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    parts = [xp[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(parts, dim=-1).reshape(b, h * w, 9 * c)


def forward(p: dict, x: torch.Tensor, kw: dict, ang: int = 5, scale: int = 4,
            q: Prec = F32) -> torch.Tensor:
    """x [B, A*h, A*w, 1] float32 LR SAI mosaics -> SR [B, A*h*s, A*w*s, 1]."""
    C = widths(kw)["C"]
    dev = x.device
    v = sai_to_views(x[..., 0], ang)  # [B, A, A, h, w]
    b, _, _, h, w = v.shape
    n = ang * ang
    up = bicubic(v.reshape(b * n, 1, h, w), scale).reshape(b, ang, ang, h * scale, w * scale)
    up = views_to_sai(up)[..., None]

    y = conv(q, v.reshape(b * n, h, w, 1), p["Conv_0.weight"], padding=1)
    z = y
    for j in range(3):
        z = q(lrelu(conv(q, z, p[f"_ViewConv3Act_0.Conv_{j}.weight"], padding=1), 0.2))
    y = q(z + y).reshape(b, n, h, w, C)
    skip = y
    ang_pe = torch.as_tensor(sincos(n, C), dtype=torch.float32, device=dev)[None]
    rows, cols = sincos(h, C), sincos(w, C)
    spa_pe = torch.as_tensor((rows[:, None] + cols[None, :]) / 2.0, dtype=torch.float32,
                             device=dev)[None]
    banded = _banded(h, w)
    for i in range(widths(kw)["blocks"]):
        tok = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, n, C)
        tok = _block(q, p, f"_AngTrans_{i}", tok, ang_pe, _full, F32)
        y = tok.reshape(b, h, w, n, C).permute(0, 3, 1, 2, 4)
        s = f"_SpaTrans_{i}"
        tok = _lin(q, p, f"{s}.embed", _unfold3(y.reshape(b * n, h, w, C)))
        pe = _lin(q, p, f"{s}.embed", _unfold3(spa_pe))
        tok = _block(q, p, s, tok, pe, banded, q)
        y = _lin(q, p, f"{s}.Dense_0", tok).reshape(b, n, h, w, C)
    y = q(y + skip)
    sai = views_to_sai(y.reshape(b, ang, ang, h, w, C).permute(0, 5, 1, 2, 3, 4))
    out = pw(q, sai.permute(0, 2, 3, 1), p["Conv_1.weight"])
    out = q(lrelu(pixel_shuffle(out, scale), 0.2))
    return conv(q, out, p["Conv_2.weight"], padding=1) + up

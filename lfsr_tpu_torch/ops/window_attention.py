"""K6 — the fused Swin-style window attention block.

Port of lfsr_tpu/ops/pallas_attention.py::window_mha_fused (Pallas kernel
``_win_mha_kernel``): per ws x ws window, LayerNorm (centred two-pass
variance, as the TPU kernel) -> qkv [C, 3C] -> per-head
softmax(q k^T / sqrt(hd) + rel-pos bias) v -> out-proj [C, C] ->
``x + attn_scale * out``. ``bias`` is [T, heads*T] with head h's [T, T]
block at column offset h*T (T = ws*ws).

On CUDA tensors :func:`window_mha_fused` launches csrc/window_attention.cu;
on CPU tensors it runs the plain twin :func:`window_mha_plain` (the port of
``window_mha_ref``). All math is float32; x's dtype is kept for I/O. When a
gradient is wanted it goes through ``_cuda.PlainVJP`` (kernel forward, the
twin's gradient), as the JAX custom_vjp (pallas_attention.py:215-227)
differentiates the XLA reference.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops import _cuda


def window_mha_plain(x, wqkv, wout, ln_g, ln_b, bias, attn_scale, ws: int = 8,
                     heads: int = 4, eps: float = 1e-6):
    """Plain twin of K6. x [B, H, W, C] with H, W multiples of ws."""
    B, H, W, C = x.shape
    T = ws * ws
    hd = C // heads
    f32 = torch.float32
    xw = x.to(f32).reshape(B, H // ws, ws, W // ws, ws, C)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, T, C)

    mu = xw.mean(-1, keepdim=True)
    xc = xw - mu
    var = (xc * xc).mean(-1, keepdim=True)
    ln = xc * torch.rsqrt(var + eps) * ln_g.to(f32) + ln_b.to(f32)

    q, k, v = (ln @ wqkv.to(f32)).split(C, dim=-1)
    q = q.reshape(-1, T, heads, hd) * (1.0 / (hd**0.5))
    k = k.reshape(-1, T, heads, hd)
    v = v.reshape(-1, T, heads, hd)
    s = torch.einsum("wihd,wjhd->whij", q, k)
    s = s + bias.to(f32).reshape(T, heads, T).permute(1, 0, 2)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("whij,wjhd->wihd", p, v).reshape(-1, T, C)
    out = (o @ wout.to(f32)) * attn_scale.to(f32).reshape(())

    out = out.reshape(B, H // ws, W // ws, ws, ws, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    return (x.to(f32) + out).to(x.dtype)


@_cuda.counted
def window_mha_fused(x, wqkv, wout, ln_g, ln_b, bias, attn_scale, ws: int = 8,
                     heads: int = 4, eps: float = 1e-6):
    """K6: kernel on CUDA tensors, plain twin on CPU tensors. Weights,
    LayerNorm params, bias and the one-element attn_scale are float32; all
    tensors are differentiable."""
    if _cuda.wants_grad(x, wqkv, wout, ln_g, ln_b, bias, attn_scale):
        return _cuda.PlainVJP.apply(_window_mha, window_mha_plain, x, wqkv, wout, ln_g, ln_b,
                                    bias, attn_scale, ws, heads, eps)
    return _window_mha(x, wqkv, wout, ln_g, ln_b, bias, attn_scale, ws, heads, eps)


def _window_mha(x, wqkv, wout, ln_g, ln_b, bias, attn_scale, ws, heads, eps):
    if _cuda.use_plain(x):
        return window_mha_plain(x, wqkv, wout, ln_g, ln_b, bias, attn_scale, ws, heads, eps)
    B, H, W, C = x.shape
    T = ws * ws
    f32, dev = torch.float32, x.device
    code = _cuda.dtype_code(x, "x")
    _cuda.check(x, "x")
    _cuda.check(wqkv, "wqkv", (C, 3 * C), f32, dev)
    _cuda.check(wout, "wout", (C, C), f32, dev)
    _cuda.check(ln_g, "ln_g", (C,), f32, dev)
    _cuda.check(ln_b, "ln_b", (C,), f32, dev)
    _cuda.check(bias, "bias", (T, heads * T), f32, dev)
    _cuda.check(attn_scale, "attn_scale", (1,), f32, dev)
    if H % ws or W % ws or C % heads or C > 80 or T > 64:
        raise ValueError(f"window kernel takes H, W multiples of ws, C % heads == 0, "
                         f"C <= 80 and ws <= 8; got {tuple(x.shape)}, ws={ws}, heads={heads}")
    y = torch.empty_like(x)
    hd = C // heads
    _cuda.launch("lfsr_window_mha", x.data_ptr(), wqkv.data_ptr(), wout.data_ptr(),
                 ln_g.data_ptr(), ln_b.data_ptr(), bias.data_ptr(), attn_scale.data_ptr(),
                 y.data_ptr(), B, H, W, C, ws, heads, 1.0 / (hd**0.5), eps, code,
                 _cuda.stream_of(x))
    window_mha_fused.launches += 1
    return y

"""K6 — the fused Swin-style window attention block.

Port of lfsr_tpu/ops/pallas_attention.py::window_mha_fused (Pallas kernel
``_win_mha_kernel``): per ws x ws window, LayerNorm (centred two-pass
variance, as the TPU kernel) -> qkv [C, 3C] -> per-head
softmax(q k^T / sqrt(hd) + rel-pos bias) v -> out-proj [C, C] ->
``x + attn_scale * out``. ``bias`` is [T, heads*T] with head h's [T, T]
block at column offset h*T (T = ws*ws).

On CUDA tensors :func:`window_mha_fused` launches one of the two kernels of
csrc/window_attention.cu, chosen by :func:`kernel_path` from the shape
alone: ws 8 with a head dim that is a multiple of 8 and C <= 88 (the
flagship's 64 channels, 4 heads of 16) runs on the tensor cores (``"mma"``:
persistent CTAs laid out by :func:`mma_plan`, bf16x3 products: each
operand split into two bf16, 16 of float32's 24 mantissa bits), the rest
on the CUDA cores (``"fma"``: the dryrun's head dim 4, the 72-wide V8
geometry's 18). The choice is a rule, not a fallback: a kernel that fails
to build or launch raises. ``launches/K6/<path>`` counts the launches of each.
On CPU tensors it runs the plain twin :func:`window_mha_plain` (the port of
``window_mha_ref``). All math is float32; x's dtype is kept for I/O. When
a gradient is wanted it goes through ``_cuda.PlainVJP`` (kernel forward,
the twin's gradient), as the JAX custom_vjp (pallas_attention.py:215-227)
differentiates the XLA reference.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops import _cuda

SMEM_LIMIT = 227 * 1024
# the tensor-core kernel: 64-token windows, C <= MMA_MAX_C (its plan must fit
# a CTA in float32), at most MAX_WINDOWS_PER_CTA windows held by a CTA at once
MMA_WS, MMA_MAX_C, MAX_WINDOWS_PER_CTA = 8, 88, 2
# the CUDA-core kernel's limits: a [C, 3C] + [C, C] weight and a window in
# shared memory
FMA_MAX_C, FMA_MAX_TOKENS = 80, 64
# K6's two kernels, each counted in the trace table as launches/K6/<path>
PATHS = ("mma", "fma")


def kernel_path(C: int, heads: int, ws: int) -> str:
    """Which K6 kernel takes a call: ``"mma"`` (tensor cores) for ws 8, a
    head dim C / heads that is a multiple of 8 and C <= MMA_MAX_C, in float32
    and bfloat16 alike; else ``"fma"`` (CUDA cores)."""
    hd_ok = heads > 0 and C % heads == 0 and (C // heads) % 8 == 0
    return "mma" if ws == MMA_WS and hd_ok and C <= MMA_MAX_C else "fma"


def _pad_words(words: int, r: int, mod: int) -> int:
    return words + (r - words) % mod


def mma_smem_bytes(C: int, itemsize: int, windows: int) -> int:
    """Shared memory of a tensor-core CTA holding ``windows`` windows at once
    (``MmaPlan``, csrc/window_attention.cu): Wqkv and Wout split for bf16x3
    in fragment order (ceil(C/16) x C/8 x 4 fragments of 512 bytes), LN gamma
    and beta, and per window an x buffer of 64 rows (row strides 8 mod 16
    words for float32, 4 mod 8 for bfloat16), K as 64 rows of C/2 channel
    pairs and V as 32 rows (key pairs) of C channels, 8 bytes each (hi, lo),
    at strides of 4 mod 16."""
    ks, nt = -(-C // 16), C // 8
    xw = C * itemsize // 4
    ldx_words = _pad_words(xw, 8, 16) if itemsize == 4 else _pad_words(xw, 4, 8)
    ldk, ldv = _pad_words(C // 2, 4, 16), _pad_words(C, 4, 16)
    fixed = ks * 4 * nt * 512 + 8 * C
    per_window = 64 * 4 * ldx_words + 64 * 8 * ldk + 32 * 8 * ldv
    return fixed + windows * per_window


def mma_plan(B: int, H: int, W: int, C: int, itemsize: int, sms: int) -> tuple[int, int, int]:
    """(CTAs, windows a CTA holds at once, shared-memory bytes) of the
    tensor-core kernel on a [B, H, W, C] map on a card with ``sms`` SMs: as
    many windows a CTA as fit, up to MAX_WINDOWS_PER_CTA; one persistent CTA
    an SM at most, each window group walking its windows."""
    per_cta = next((w for w in range(MAX_WINDOWS_PER_CTA, 0, -1)
                    if mma_smem_bytes(C, itemsize, w) <= SMEM_LIMIT), 0)
    if per_cta == 0:
        raise ValueError(f"window kernel (tensor cores): C={C} does not fit a CTA")
    windows = B * (H // 8) * (W // 8)
    return min(sms, -(-windows // per_cta)), per_cta, mma_smem_bytes(C, itemsize, per_cta)


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


@_cuda.counted("K6", PATHS)
def window_mha_fused(x, wqkv, wout, ln_g, ln_b, bias, attn_scale, ws: int = 8,
                     heads: int = 4, eps: float = 1e-6):
    """K6: kernel on CUDA tensors, plain twin on CPU tensors. Weights,
    LayerNorm params, bias and the one-element attn_scale are float32; all
    tensors are differentiable."""
    if _cuda.wants_grad(x, wqkv, wout, ln_g, ln_b, bias, attn_scale):
        return _cuda.PlainVJP.apply("K6", _window_mha, window_mha_plain, x, wqkv, wout, ln_g, ln_b,
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
    if H % ws or W % ws or C % heads:
        raise ValueError(f"window kernel takes H, W multiples of ws and C % heads == 0; "
                         f"got {tuple(x.shape)}, ws={ws}, heads={heads}")
    path = kernel_path(C, heads, ws)
    if path == "fma" and (C > FMA_MAX_C or T > FMA_MAX_TOKENS):
        raise ValueError(f"window kernel (CUDA cores) takes C <= {FMA_MAX_C} and ws <= 8; "
                         f"got {tuple(x.shape)}, ws={ws}, heads={heads}")
    y = torch.empty_like(x)
    hd = C // heads
    args = (x.data_ptr(), wqkv.data_ptr(), wout.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
            bias.data_ptr(), attn_scale.data_ptr(), y.data_ptr(), B, H, W, C)
    if path == "mma":
        if any(t.data_ptr() % 16 for t in (x, y, bias)):
            raise ValueError("window kernel (tensor cores): x and bias must be 16-byte aligned")
        plan = mma_plan(B, H, W, C, x.element_size(), _cuda.sm_count(x))
        _cuda.launch("lfsr_window_mha_mma", *args, heads, 1.0 / (hd**0.5), eps, *plan, code,
                     _cuda.stream_of(x))
    else:
        _cuda.launch("lfsr_window_mha", *args, ws, heads, 1.0 / (hd**0.5), eps, code,
                     _cuda.stream_of(x))
    _cuda.launched("K6", path)
    return y

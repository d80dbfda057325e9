"""K7 — the LFVSSMBlock front: LayerNorm + MultiScaleLocal in one pass.

Port of lfsr_tpu/ops/pallas_block.py::ln_msl (Pallas kernel
``_ln_msl_kernel``). The block takes it once a call carries at least
``LN_MSL_MIN_PIXELS`` pixels on a square, 8-aligned map
(:func:`ln_msl_supported`, the TPU gate ``pallas_block._supported``
without its backend test); below that gate the block runs the plain
LayerNorm + MultiScaleLocal modules, as the TPU does.

On a CUDA tensor :func:`ln_msl` launches csrc/ln_msl.cu; on a CPU tensor
it runs the plain twin :func:`ln_msl_plain` (the port of ``ln_msl_ref``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfsr_tpu_torch.ops import _cuda
from lfsr_tpu_torch.ops.cross_scan import EPS, layer_norm_fast

LN_MSL_MIN_PIXELS = 4 * 160 * 160


def ln_msl_supported(x: torch.Tensor) -> bool:
    """The TPU's K7 gate (pallas_block._supported) without the backend
    test: a square 4-D map of at least LN_MSL_MIN_PIXELS pixels whose side
    and head-channel count fit the TPU's tiles (the tile follows x's dtype,
    so the block's float32 input gives 8)."""
    if x.dim() != 4:
        return False
    b, h, w, c = x.shape
    g_tile = 16 if x.dtype == torch.bfloat16 else 8
    return (h == w and h >= 8 and c % 4 == 0 and b * h * w >= LN_MSL_MIN_PIXELS
            and h % 8 == 0 and (c // 4) % g_tile == 0)


def ln_msl_plain(x, gamma, beta, whm, wrest, wk, slope: float = 0.1):
    """Plain K7: returns (xn, local) with xn = LN(x) in x.dtype and
    local = lrelu(xn[..., :c4] @ whm + dw3x3(xn[..., c4:]) @ wrest) + xn.
    whm [c4, C]; wrest [C-c4, C]; wk [3, 3, C-c4]."""
    c4 = whm.shape[0]
    xn = layer_norm_fast(x, gamma, beta).to(x.dtype)
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(xn[..., c4:], (0, 0, 1, 1, 1, 1))
    rest = None
    for ky in range(3):
        for kx in range(3):
            term = xp[:, ky : ky + H, kx : kx + W, :] * wk[ky, kx]
            rest = term if rest is None else rest + term
    y = xn[..., :c4] @ whm + rest @ wrest
    y = torch.where(y >= 0, y, slope * y)
    return xn, y + xn


@_cuda.counted
def ln_msl(x, gamma, beta, whm, wrest, wk, slope: float = 0.1):
    """K7: x [B, H, W, C]; gamma/beta [C] float32; whm [c4, C], wrest
    [C-c4, C] and wk [3, 3, C-c4] in x's dtype. Returns (xn, local)."""
    if _cuda.use_plain(x):
        return ln_msl_plain(x, gamma, beta, whm, wrest, wk, slope)
    b, h, w, c = x.shape
    c4 = whm.shape[0]
    dt, dev = x.dtype, x.device
    code = _cuda.dtype_code(x, "x")
    _cuda.check(x, "x")
    _cuda.check(gamma, "gamma", (c,), torch.float32, dev)
    _cuda.check(beta, "beta", (c,), torch.float32, dev)
    _cuda.check(whm, "whm", (c4, c), dt, dev)
    _cuda.check(wrest, "wrest", (c - c4, c), dt, dev)
    _cuda.check(wk, "wk", (3, 3, c - c4), dt, dev)
    if c % 16 or c > 128 or not 0 < c4 < c:
        raise ValueError(f"ln_msl kernel takes C % 16 == 0, C <= 128 and 0 < c4 < C; "
                         f"got C={c}, c4={c4}")
    xn, local = torch.empty_like(x), torch.empty_like(x)
    _cuda.launch("lfsr_ln_msl", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 whm.data_ptr(), wrest.data_ptr(), wk.data_ptr(), xn.data_ptr(),
                 local.data_ptr(), b, h, w, c, c4, slope, EPS, code, _cuda.stream_of(x))
    ln_msl.launches += 1
    return xn, local

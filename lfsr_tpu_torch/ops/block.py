"""K7 — the LFVSSMBlock front: LayerNorm + MultiScaleLocal in one pass.

Port of lfsr_tpu/ops/pallas_block.py::ln_msl (Pallas kernel
``_ln_msl_kernel``). The outputs (xn, local) come in the weights' dtype,
the compute dtype. x is of that dtype, or float32 with bfloat16 weights:
the float32-input mode, whose LayerNorm reads float32 x and rounds only
xn, which is JAX's plain branch (LayerNorm on the block's float32 residual
stream, then MultiScaleLocal; ``lfsr_tpu/models/lfmambax.py:317-318``).

The block takes the kernel wherever :func:`ln_msl_takes` holds (C a
multiple of 16 up to 128, any B, H, W). The TPU's work gate
(:func:`ln_msl_supported`, ``pallas_block._supported`` without its backend
test, a v5e measurement) now picks only the mode: where it holds, x is
rounded to the compute dtype first, as on the TPU (JAX's K7 branch);
elsewhere K7 runs in the float32-input mode (JAX's plain branch). So the
port computes JAX's function at every shape.

On a CUDA tensor :func:`ln_msl` launches one of the two kernels of
csrc/ln_msl.cu, chosen by the weights' dtype (:func:`kernel_path`):
``"mma"`` for bfloat16 (tensor cores; x float32 or bfloat16), ``"fma"`` for
float32 (CUDA cores); ``launches/K7/<path>`` counts each. On a CPU tensor it
runs the plain twin :func:`ln_msl_plain` (the port of ``ln_msl_ref``, and
of the plain branch in the float32-input mode). When a gradient is wanted
it goes through ``_cuda.PlainVJP`` (kernel forward, the twin's gradient),
as the JAX custom_vjp (pallas_block.py:236-247) differentiates the
reference and the plain branch its own ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfsr_tpu_torch.ops import _cuda
from lfsr_tpu_torch.ops.cross_scan import EPS, layer_norm_fast

LN_MSL_MIN_PIXELS = 4 * 160 * 160
# K7's two kernels, each counted in the trace table as launches/K7/<path>
PATHS = ("mma", "fma")


def ln_msl_supported(x: torch.Tensor) -> bool:
    """The TPU's K7 gate (pallas_block._supported) without the backend
    test: a square 4-D map of at least LN_MSL_MIN_PIXELS pixels whose side
    and head-channel count fit the TPU's tiles (the tile follows x's dtype,
    so the block's float32 input gives 8). The block rounds x to the
    compute dtype before K7 where it holds."""
    if x.dim() != 4:
        return False
    b, h, w, c = x.shape
    g_tile = 16 if x.dtype == torch.bfloat16 else 8
    return (h == w and h >= 8 and c % 4 == 0 and b * h * w >= LN_MSL_MIN_PIXELS
            and h % 8 == 0 and (c // 4) % g_tile == 0)


def ln_msl_takes(x: torch.Tensor, c4: int) -> bool:
    """The kernels' own envelope: a 4-D map of C channels, C a multiple of
    16 up to 128, with 0 < c4 < C head channels; any B, H and W."""
    if x.dim() != 4:
        return False
    c = x.shape[-1]
    return c % 16 == 0 and c <= 128 and 0 < c4 < c


def kernel_path(dtype: torch.dtype) -> str:
    """Which K7 kernel takes a call with weights (and outputs) of
    ``dtype``: ``"mma"`` (tensor cores) for bfloat16, ``"fma"`` (CUDA cores)
    for float32."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def msl_plain(xn, whm, wrest, wk, slope: float = 0.1):
    """The local branch on xn (of the weights' dtype):
    lrelu(xn[..., :c4] @ whm + dw3x3(xn[..., c4:]) @ wrest) + xn, the 9
    taps in (ky, kx) order. whm [c4, C]; wrest [C-c4, C]; wk [3, 3, C-c4]."""
    c4 = whm.shape[0]
    H, W = xn.shape[1], xn.shape[2]
    xp = F.pad(xn[..., c4:], (0, 0, 1, 1, 1, 1))
    rest = None
    for ky in range(3):
        for kx in range(3):
            term = xp[:, ky : ky + H, kx : kx + W, :] * wk[ky, kx]
            rest = term if rest is None else rest + term
    y = xn[..., :c4] @ whm + rest @ wrest
    y = torch.where(y >= 0, y, slope * y)
    return y + xn


def ln_msl_plain(x, gamma, beta, whm, wrest, wk, slope: float = 0.1):
    """Plain K7: returns (xn, local) in the weights' dtype dt, with
    xn = LN(x) rounded to dt (x float32 or dt) and local = msl_plain(xn)."""
    xn = layer_norm_fast(x, gamma, beta).to(whm.dtype)
    return xn, msl_plain(xn, whm, wrest, wk, slope)


@_cuda.counted("K7", PATHS)
def ln_msl(x, gamma, beta, whm, wrest, wk, slope: float = 0.1):
    """K7: x [B, H, W, C] of the weights' dtype, or float32 with bfloat16
    weights (the float32-input mode); gamma/beta [C] float32; whm [c4, C],
    wrest [C-c4, C] and wk [3, 3, C-c4] of one dtype. Returns (xn, local)
    in the weights' dtype; differentiable in every tensor."""
    if _cuda.wants_grad(x, gamma, beta, whm, wrest, wk):
        return _cuda.PlainVJP.apply("K7", _ln_msl, ln_msl_plain, x, gamma, beta, whm, wrest, wk,
                                    slope)
    return _ln_msl(x, gamma, beta, whm, wrest, wk, slope)


def _ln_msl(x, gamma, beta, whm, wrest, wk, slope):
    if _cuda.use_plain(x):
        return ln_msl_plain(x, gamma, beta, whm, wrest, wk, slope)
    b, h, w, c = x.shape
    c4 = whm.shape[0]
    dt, dev = whm.dtype, x.device
    code = _cuda.dtype_code(whm, "whm")
    x_code = _cuda.dtype_code(x, "x")
    if x.dtype not in (dt, torch.float32):
        raise ValueError(f"ln_msl: x must be {dt} or float32 (the float32-input mode), "
                         f"got {x.dtype}")
    _cuda.check(x, "x")
    _cuda.check(gamma, "gamma", (c,), torch.float32, dev)
    _cuda.check(beta, "beta", (c,), torch.float32, dev)
    _cuda.check(whm, "whm", (c4, c), dt, dev)
    _cuda.check(wrest, "wrest", (c - c4, c), dt, dev)
    _cuda.check(wk, "wk", (3, 3, c - c4), dt, dev)
    if not ln_msl_takes(x, c4):
        raise ValueError(f"ln_msl kernel takes C % 16 == 0, C <= 128 and 0 < c4 < C; "
                         f"got C={c}, c4={c4}")
    if x.data_ptr() % 16:
        raise ValueError("ln_msl: x must be 16-byte aligned")
    xn = torch.empty(x.shape, dtype=dt, device=dev)
    local = torch.empty_like(xn)
    _cuda.launch("lfsr_ln_msl", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 whm.data_ptr(), wrest.data_ptr(), wk.data_ptr(), xn.data_ptr(),
                 local.data_ptr(), b, h, w, c, c4, slope, EPS, x_code, code,
                 _cuda.stream_of(x))
    _cuda.launched("K7", kernel_path(dt))
    return xn, local

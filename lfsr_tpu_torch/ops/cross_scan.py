"""K4 / K5 — the 4-way cross-scan permutation around the shared Mamba.

Port of lfsr_tpu/ops/pallas_layout.py::cross_scan_gather (K4) and
::cross_scan_scatter (K5). Channel quarters 0..3 of an [B, H, W, C] map
read the raster row-major, reversed row-major, column-major and reversed
column-major.

- ``cross_scan_gather(x, gamma, beta)``: permute into [B, H*W, C] and
  apply LayerNorm over C (flax fast-variance form, eps 1e-6).
- ``cross_scan_scatter(seq, x, w, scale)``: inverse permutation, 1x1 C x C
  mix ``w`` ([C_in, C_out]), then ``x + scale * y``.

On CUDA tensors the wrappers launch the kernels in csrc/cross_scan.cu; on
CPU tensors they run the plain twins (ports of the ``_ref`` functions).
K4 has two kernels, chosen by :func:`gather_path`: ``"tile"`` (a channel
quarter a multiple of 8 bytes: tiles of :func:`gather_tile` consecutive
positions, each quarter copied from a run of pixels, LayerNorm from shared
memory) and ``"warp"`` (the other widths: a warp a position);
``GATHER_PATH_LAUNCHES`` counts each. K5 has two kernels, chosen by
:func:`kernel_path`: ``"mma"`` (bfloat16, C a multiple of 16: the mix on
the tensor cores, 2-D tiles of :func:`scatter_tile` pixels read from seq in
runs of consecutive positions) and ``"fma"`` (the rest: CUDA cores);
``PATH_LAUNCHES`` counts each. Each choice is a rule, not a fallback: a
kernel that fails to launch raises.
When a gradient is wanted they go through ``_cuda.PlainVJP``: the kernel
forward, the plain twin's gradient (the JAX custom_vjps at
pallas_layout.py:302-311 and :430-439 differentiate the XLA reference).
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops import _cuda

EPS = 1e-6
# K5's launches of each kernel (their sum is cross_scan_scatter.launches)
PATH_LAUNCHES = {"mma": 0, "fma": 0}
# K4's launches of each kernel (their sum is cross_scan_gather.launches)
GATHER_PATH_LAUNCHES = {"tile": 0, "warp": 0}
# K4 "tile": a call is cut into at least this many tiles where it can be
# (about 8 for each of the H100's 132 SMs)
GATHER_MIN_TILES = 1024


def layer_norm_fast(x: torch.Tensor, gamma, beta, eps: float = EPS) -> torch.Tensor:
    """flax LayerNorm over the last axis: float32 statistics with the
    fast-variance form max(E[x^2] - E[x]^2, 0); returns float32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * gamma.float()) + beta.float()


def _permute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> the 4-way cross-scan sequence [B, H*W, C]."""
    b, h, w, c = x.shape
    g = c // 4
    s0 = x[..., :g].reshape(b, h * w, g)
    s1 = x[..., g : 2 * g].reshape(b, h * w, g).flip(1)
    s2 = x[..., 2 * g : 3 * g].transpose(1, 2).reshape(b, h * w, g)
    s3 = x[..., 3 * g :].transpose(1, 2).reshape(b, h * w, c - 3 * g).flip(1)
    return torch.cat([s0, s1, s2, s3], dim=-1)


def _unpermute(seq: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`_permute`: [B, H*W, C] -> [B, H, W, C]."""
    b, _, c = seq.shape
    g = c // 4
    r0 = seq[..., :g].reshape(b, h, w, g)
    r1 = seq[..., g : 2 * g].flip(1).reshape(b, h, w, g)
    r2 = seq[..., 2 * g : 3 * g].reshape(b, w, h, g).transpose(1, 2)
    r3 = seq[..., 3 * g :].flip(1).reshape(b, w, h, c - 3 * g).transpose(1, 2)
    return torch.cat([r0, r1, r2, r3], dim=-1)


def cross_scan_gather_plain(x, gamma, beta):
    """Plain twin of K4 (``cross_scan_gather_ref``)."""
    return layer_norm_fast(_permute(x), gamma, beta).to(x.dtype)


def cross_scan_scatter_plain(seq, x, w, scale):
    """Plain twin of K5 (``cross_scan_scatter_ref``): the mix runs in w's
    dtype, the residual in float32."""
    b, h, wd, c = x.shape
    y = _unpermute(seq, h, wd).to(w.dtype) @ w
    return (x.float() + scale.float() * y.float()).to(x.dtype)


def kernel_path(dtype: torch.dtype, c: int) -> str:
    """Which K5 kernel takes a call: ``"mma"`` (tensor cores) for bfloat16
    with C a multiple of 16, else ``"fma"`` (CUDA cores)."""
    return "mma" if dtype == torch.bfloat16 and c % 16 == 0 else "fma"


def gather_path(dtype: torch.dtype, c: int) -> str:
    """Which K4 kernel takes a call: ``"tile"`` where a channel quarter is a
    multiple of 8 bytes (bfloat16 C % 16 == 0, float32 C % 8 == 0: the
    tile kernel's 8- or 16-byte copies), else ``"warp"``."""
    return "tile" if (c // 4) * torch.finfo(dtype).bits // 8 % 8 == 0 else "warp"


def gather_tile(dtype: torch.dtype, c: int, b: int, l: int) -> int:
    """Consecutive sequence positions a K4 "tile" CTA takes at C channels
    on b sequences of l positions: the power of two nearest below 16 KB of
    rows, within 64..256 (128 at bfloat16 C 64), halved down to 64 while
    the call has fewer than ``GATHER_MIN_TILES`` tiles (the tiled eval's
    [2, 160, 160] map: 64), so a small call still gives each CTA a next
    tile to copy while it normalises one. Two buffers of T rows of C + C/4
    are 40 KB at 16 KB of rows: several CTAs an SM. A multiple of 64, so
    every thread of the LayerNorm's groups (at most 32 lanes a row, 256
    threads) runs the same passes."""
    rows = 16384 // (c * torch.finfo(dtype).bits // 8)
    t = max(64, min(256, 1 << (rows.bit_length() - 1)))
    while t > 64 and b * -(-l // t) < GATHER_MIN_TILES:
        t //= 2
    return t


def scatter_tile(c: int) -> tuple[int, int]:
    """(rows, columns) of the pixel tile a K5 "mma" CTA takes at C channels:
    16 x 16 up to 64 channels, 8 x 16 above. Its shared memory (W^T and two
    tiles, csrc/cross_scan.cu ``scatter_mma::smem_bytes``) is then 83 KB at
    64 channels and 102 KB at 128: two CTAs an SM. Quarters 0 and 1 read
    runs of 16 consecutive sequence positions along tile rows, 2 and 3 runs
    of 16 (8) along tile columns."""
    return (16 if c <= 64 else 8), 16


@_cuda.counted
def cross_scan_gather(x, gamma, beta):
    """K4: x [B, H, W, C] -> LayerNorm(4-way permuted x) [B, H*W, C];
    differentiable in x, gamma and beta."""
    if _cuda.wants_grad(x, gamma, beta):
        return _cuda.PlainVJP.apply(_gather, cross_scan_gather_plain, x, gamma, beta)
    return _gather(x, gamma, beta)


def _gather(x, gamma, beta):
    if _cuda.use_plain(x):
        return cross_scan_gather_plain(x, gamma, beta)
    b, h, w, c = x.shape
    code = _cuda.dtype_code(x, "x")
    _cuda.check(x, "x")
    _cuda.check(gamma, "gamma", (c,), torch.float32, x.device)
    _cuda.check(beta, "beta", (c,), torch.float32, x.device)
    if c % 4 or c > 128:
        raise ValueError(f"cross-scan kernels take C % 4 == 0 and C <= 128, got C={c}")
    out = torch.empty((b, h * w, c), dtype=x.dtype, device=x.device)
    path = gather_path(x.dtype, c)
    if path == "tile":
        if any(t.data_ptr() % 16 for t in (x, out)):
            raise ValueError("cross_scan_gather: x and out must be 16-byte aligned")
        _cuda.launch("lfsr_cross_scan_gather_tile", x.data_ptr(), gamma.data_ptr(),
                     beta.data_ptr(), out.data_ptr(), b, h, w, c,
                     gather_tile(x.dtype, c, b, h * w), EPS, code, _cuda.stream_of(x))
    else:
        _cuda.launch("lfsr_cross_scan_gather", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     out.data_ptr(), b, h, w, c, EPS, code, _cuda.stream_of(x))
    cross_scan_gather.launches += 1
    GATHER_PATH_LAUNCHES[path] += 1
    return out


@_cuda.counted
def cross_scan_scatter(seq, x, w, scale):
    """K5: un-permute seq [B, H*W, C], mix by w [C, C], return x + scale*y.
    ``scale`` is a one-element float32 tensor (read on the device).
    Differentiable in seq, x, w and scale."""
    if _cuda.wants_grad(seq, x, w, scale):
        return _cuda.PlainVJP.apply(_scatter, cross_scan_scatter_plain, seq, x, w, scale)
    return _scatter(seq, x, w, scale)


def _scatter(seq, x, w, scale):
    if _cuda.use_plain(x):
        return cross_scan_scatter_plain(seq, x, w, scale)
    b, h, wd, c = x.shape
    code = _cuda.dtype_code(x, "x")
    _cuda.check(x, "x")
    _cuda.check(seq, "seq", (b, h * wd, c), x.dtype, x.device)
    _cuda.check(w, "w", (c, c), x.dtype, x.device)
    _cuda.check(scale, "scale", (1,), torch.float32, x.device)
    if c % 4 or c > 128:
        raise ValueError(f"cross-scan kernels take C % 4 == 0 and C <= 128, got C={c}")
    out = torch.empty_like(x)
    path = kernel_path(x.dtype, c)
    if path == "mma":
        if any(t.data_ptr() % 16 for t in (seq, x, out)):
            raise ValueError("cross_scan_scatter: seq, x and out must be 16-byte aligned")
        th, tw = scatter_tile(c)
        _cuda.launch("lfsr_cross_scan_scatter_mma", seq.data_ptr(), x.data_ptr(), w.data_ptr(),
                     scale.data_ptr(), out.data_ptr(), b, h, wd, c, th, tw, _cuda.stream_of(x))
    else:
        _cuda.launch("lfsr_cross_scan_scatter", seq.data_ptr(), x.data_ptr(), w.data_ptr(),
                     scale.data_ptr(), out.data_ptr(), b, h, wd, c, code, _cuda.stream_of(x))
    cross_scan_scatter.launches += 1
    PATH_LAUNCHES[path] += 1
    return out

"""K10 — the HLFR tail: expansion matmul + lrelu + folded 3x3 out-conv taps.

Port of lfsr_tpu/ops/pallas_head.py::hlfr_tail and its custom_vjp. The TPU
retired its Pallas kernel (``_supported()`` is False outside tests,
pallas_head.py:90-103, for Mosaic lane-layout reasons) and runs the plain
chain ``hlfr_tail_ref``; Hopper has no such limit, so the port runs its
kernel (csrc/hlfr_tail.cu), which keeps the expanded z and the taps'
product out of device memory. :func:`hlfr_tail` is the model's entry,
once per flagship forward: the kernel on a CUDA tensor, the plain twin
:func:`hlfr_tail_plain` (the reference chain) on a CPU tensor, and with a
gradient wanted ``_cuda.PlainVJP`` (the twin's gradient, as ``_ht_bwd``
differentiates the reference). The kernel is the dtype's
(:func:`kernel_path`): ``"mma"`` for bfloat16 (tensor cores, tiles of 16 x
30 output pixels, the next tile's halo copied by ``cp.async`` while one
computes) and ``"f32"`` for float32 (CUDA cores, 16 x 16 tiles); the
wrapper passes the tile (``TAIL_TILES``) and the kernel refuses another.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops import _cuda

# the kernel's shapes: channels of y, and rr (the last pixel-shuffle stage, r = 2)
TAIL_CHANNELS, TAIL_RR = (16, 32, 48, 64), 4
# output pixels (rows, columns) a CTA of each kernel takes: the halo is two
# more each way, 18 x 32 = 576 pixels (36 m-tiles of 16, 12 warps of 3) for
# "mma", 18 x 18 = 324 (a thread each) for "f32"
TAIL_TILES = {"mma": (16, 30), "f32": (16, 16)}


def kernel_path(dtype: torch.dtype) -> str:
    """K10's kernel for y of ``dtype``: ``"mma"`` (bfloat16, tensor cores)
    or ``"f32"`` (float32, CUDA cores)."""
    return "mma" if dtype == torch.bfloat16 else "f32"


def hlfr_tail_plain(y, w1, kf, bias, slope: float = 0.1):
    """y [B, H, W, C] (compute dtype); w1 [C, Cz]; kf [3, 3, Cz, rr];
    bias [1]. Returns [B, H, W, rr] float32."""
    from lfsr_tpu_torch.models.lfmambax import apply_folded_taps

    dt = y.dtype
    z = y @ w1.to(dt)
    z = torch.where(z >= 0, z, slope * z)
    return apply_folded_taps(z.to(dt), kf.to(dt), bias)


def _hlfr_tail(y, w1, kf, bias, slope=0.1):
    """K10: kernel on CUDA tensors, plain twin on CPU tensors. The kernel
    takes y in float32 or bfloat16 at any H and W, C in ``TAIL_CHANNELS``,
    Cz a multiple of 16, rr = ``TAIL_RR`` and a one-element bias; w1, kf
    and bias are cast as the twin casts them."""
    if _cuda.use_plain(y):
        return hlfr_tail_plain(y, w1, kf, bias, slope)
    dt, dev = y.dtype, y.device
    code = _cuda.dtype_code(y, "y")
    y = y.contiguous()
    B, H, W, C = y.shape
    kh, kw, Cz, rr = kf.shape
    if (C not in TAIL_CHANNELS or rr != TAIL_RR or (kh, kw) != (3, 3) or Cz % 16
            or bias.numel() != 1):
        raise ValueError(f"hlfr_tail kernel takes C in {TAIL_CHANNELS}, a 3x3 kf with rr = "
                         f"{TAIL_RR} and Cz % 16 == 0, and a scalar bias; got y {tuple(y.shape)}, "
                         f"kf {tuple(kf.shape)}, bias {tuple(bias.shape)}")
    w1 = w1.to(dt).contiguous()
    w36 = kf.to(dt).permute(2, 0, 1, 3).reshape(Cz, kh * kw * rr).contiguous()
    b = bias.to(torch.float32).reshape(1).contiguous()
    _cuda.check(y, "y", device=dev)
    _cuda.check(w1, "w1", (C, Cz), dt, dev)
    _cuda.check(w36, "w36", (Cz, 9 * rr), dt, dev)
    _cuda.check(b, "bias", (1,), torch.float32, dev)
    out = torch.empty((B, H, W, rr), dtype=torch.float32, device=dev)
    if y.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("hlfr_tail kernel: y and out must be 16-byte aligned")
    _cuda.launch("lfsr_hlfr_tail", y.data_ptr(), w1.data_ptr(), w36.data_ptr(), b.data_ptr(),
                 out.data_ptr(), B, H, W, C, Cz, *TAIL_TILES[kernel_path(dt)], float(slope), code,
                 _cuda.stream_of(y))
    _cuda.launched("K10")
    return out


@_cuda.counted("K10")
def hlfr_tail(y, w1, kf, bias, slope: float = 0.1):
    """K10, the model's entry: y [B, H, W, C] -> [B, H, W, rr] float32."""
    args = (y, w1, kf, bias, slope)
    if _cuda.wants_grad(*args[:4]):
        return _cuda.PlainVJP.apply("K10", _hlfr_tail, hlfr_tail_plain, *args)
    return _hlfr_tail(*args)

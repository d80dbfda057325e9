"""K8 — banded-mask multi-head attention over short sequences (EPIT).

Port of lfsr_tpu/ops/pallas_masked_attention.py::masked_mha_fused (Pallas
kernel ``_masked_mha_raw``): q, k, v [B, L, D] with channel-contiguous
heads (head h owns channels h*hd .. (h+1)*hd, hd = D / heads) and one
additive mask [L, L] shared by every sequence and head:

    o_h = softmax(q_h k_h^T / sqrt(hd) + mask) v_h     (float32 math)

returned in q's dtype. EPIT runs it at every EPI-axis attention (10 per
forward: L = 160 tokens, D = 128, 8 heads).

On CUDA tensors :func:`masked_mha_fused` launches one of the two kernels
of csrc/masked_attention.cu, chosen by :func:`kernel_path` from the dtype
and the head dim: bfloat16 with hd in (16, 32, 64) runs on the tensor
cores (``"mma"``, the mask read row-major as given), float32 or hd = 8 on
the CUDA cores (``"fma"``, the mask transposed). The choice is a rule, not
a fallback: a kernel that fails to build or launch raises.
``launches/K8/<path>`` counts the launches of each. On CPU tensors it runs
the plain twin :func:`masked_mha_plain` (the port of ``masked_mha_ref``).
When a gradient is wanted it goes through ``_cuda.PlainVJP`` (kernel
forward, the twin's gradient), as the JAX custom_vjp
(pallas_masked_attention.py:135-146) differentiates the reference: the TPU
has no backward kernel for it.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops import _cuda

# head dims the kernels are compiled for (csrc/masked_attention.cu): the
# CUDA-core kernel all four, the tensor-core kernel the last three
KERNEL_HEAD_DIMS = (8, 16, 32, 64)
MMA_HEAD_DIMS = (16, 32, 64)
_SMEM_LIMIT = 227 * 1024
# K8's two kernels, each counted in the trace table as launches/K8/<path>
PATHS = ("mma", "fma")


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """Which K8 kernel takes a call: ``"mma"`` (tensor cores) for bfloat16
    with hd in :data:`MMA_HEAD_DIMS`, else ``"fma"`` (CUDA cores; float32
    stays float32 for the gradient checks)."""
    return "mma" if dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS else "fma"


def _smem_bytes(path: str, L: int, hd: int) -> int:
    """Shared memory of a CTA: q, k, v rows of 64 channels (72 with the
    pad), L rounded up to 16, bf16 (``"mma"``); K_h and V_h in float32
    (``"fma"``)."""
    if path == "mma":
        return 3 * 2 * (-(-L // 16) * 16) * 72
    return 2 * L * hd * 4


def supported(L: int, D: int, heads: int) -> bool:
    """The JAX package's gate for its fused path (the same expression):
    lane-aligned D, 8-aligned sequence, channel-partitioned heads."""
    return D % 128 == 0 and L % 8 == 0 and D % heads == 0 and L * heads <= 4096


def masked_mha_plain(q, k, v, mask, heads: int):
    """Plain twin of K8: float32 math, q pre-scaled by 1/sqrt(hd), per-head
    softmax; output in q's dtype."""
    B, L, D = q.shape
    hd = D // heads
    f32 = torch.float32
    qh = q.to(f32).reshape(B, L, heads, hd) * (1.0 / (hd**0.5))
    kh = k.to(f32).reshape(B, L, heads, hd)
    vh = v.to(f32).reshape(B, L, heads, hd)
    s = torch.einsum("bihd,bjhd->bhij", qh, kh) + mask.to(f32)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", p, vh).reshape(B, L, D)
    return o.to(q.dtype)


@_cuda.counted("K8", PATHS)
def masked_mha_fused(q, k, v, mask, heads: int = 8):
    """K8: kernel on CUDA tensors, plain twin on CPU tensors. q, k, v
    [B, L, D] of one dtype (float32 or bfloat16), mask [L, L] float32;
    differentiable in all four."""
    if _cuda.wants_grad(q, k, v, mask):
        return _cuda.PlainVJP.apply("K8", _masked_mha, masked_mha_plain, q, k, v, mask, heads)
    return _masked_mha(q, k, v, mask, heads)


def _masked_mha(q, k, v, mask, heads):
    if _cuda.use_plain(q):
        return masked_mha_plain(q, k, v, mask, heads)
    B, L, D = q.shape
    code = _cuda.dtype_code(q, "q")
    _cuda.check(q, "q")
    _cuda.check(k, "k", q.shape, q.dtype, q.device)
    _cuda.check(v, "v", q.shape, q.dtype, q.device)
    _cuda.check(mask, "mask", (L, L), torch.float32, q.device)
    hd = D // heads if heads > 0 and D % heads == 0 else 0
    path = kernel_path(q.dtype, hd)
    if hd not in KERNEL_HEAD_DIMS or _smem_bytes(path, L, hd) > _SMEM_LIMIT:
        raise ValueError(f"masked attention kernel takes D % heads == 0, head dim in "
                         f"{KERNEL_HEAD_DIMS} and at most {_SMEM_LIMIT} bytes of shared "
                         f"memory; got {tuple(q.shape)}, heads={heads}")
    o = torch.empty_like(q)
    if path == "mma":
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("masked attention (tensor cores): q, k, v must be 16-byte aligned")
        _cuda.launch("lfsr_masked_mha_mma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     mask.data_ptr(), o.data_ptr(), B, L, D, heads, 1.0 / (hd**0.5),
                     _cuda.stream_of(q))
    else:
        # the CUDA-core kernel reads the mask by columns (a warp's query rows
        # side by side), as the JAX wrapper tiles its mask for its kernel
        mask_t = mask.t().contiguous()
        _cuda.launch("lfsr_masked_mha", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     mask_t.data_ptr(), o.data_ptr(), B, L, D, heads, 1.0 / (hd**0.5), code,
                     _cuda.stream_of(q))
    _cuda.launched("K8", path)
    return o

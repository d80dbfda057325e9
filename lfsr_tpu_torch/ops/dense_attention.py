"""K15 — multi-head attention with no mask, queries and keys of their own
lengths (LF-DET).

No TPU kernel matches it: JAX runs flax's ``nn.dot_product_attention`` as
XLA ops. q [B, Lq, D] and k, v [B, Lk, D] with channel-contiguous heads
(head h owns channels h*hd .. (h+1)*hd, hd = D / heads):

    o_h = softmax(q_h k_h^T / sqrt(hd)) v_h

returned in q's dtype, o [B, Lq, D]. LF-DET runs it at every attention (20 a
forward): its spatial-reduction attention (each view's 1,024 pixel tokens
against 256 keys from a 2x2 stride-2 conv) and its angular attention over
MacPI windows of 25, 100 and 225 tokens, 4 heads of 16.

On CUDA tensors :func:`dense_mha` launches one of the two kernels of
csrc/dense_attention.cu, chosen by :func:`kernel_path`: bfloat16 on the
tensor cores (``"mma"``, planned by :func:`mma_plan`), float32 (for the
gradient checks) on the CUDA cores (``"fma"``). Both take hd 16 alone,
LF-DET's; Lq and Lk are 1 .. :data:`MAX_LEN`; k and v may be spaced rows
(the two halves of one [B, Lk, 2D] projection: ``_cuda.row_spacing``),
read in place; other calls raise ``ValueError``. ``launches/K15`` and ``launches/K15/<path>`` count the
launches. On CPU tensors it runs the plain twin
:func:`dot_product_attention`, flax's formula. When a gradient is wanted it
goes through ``_cuda.PlainVJP`` (the kernel forward, the twin's gradient),
as K8 and K12 do: there is no backward kernel.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import _cuda

MAX_LEN = 1024
HEAD_DIM = 16  # the one head dim the kernels take (LF-DET's 4 heads of 16)
# channels a CTA of the tensor-core kernel stages (whole heads), widest first
MMA_CHANNELS = (64, 32, 16)
MMA_QUERY_ROWS = 256  # query rows a CTA of a long sequence (8 warps of 32)
MMA_ROW_STEP = 32  # query rows a warp item (two m-tiles sharing their K, V fragments)
SMEM_BYTES = 227 * 1024
# the shared memory a CTA of packed short sequences fills up to: two CTAs an SM
PACK_BYTES = 112 * 1024
MAX_PACK = 8
# K15's two kernels, each counted in the trace table as launches/K15/<path>
PATHS = ("mma", "fma")


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def kernel_path(dtype: torch.dtype) -> str:
    """Which K15 kernel takes a call: ``"mma"`` (tensor cores) for
    bfloat16, ``"fma"`` (CUDA cores) for float32, which stays float32 for
    the gradient checks."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def mma_smem_bytes(Lk: int, cw: int, S: int, QB: int) -> int:
    """A CTA's shared memory: k and v rows (Lk rounded up to 16) and QB q
    rows of S sequences, at a pitch of cw + 8 bf16."""
    return 2 * (cw + 8) * S * (2 * _up(Lk, 16) + QB)


def mma_plan(B: int, Lq: int, Lk: int, D: int) -> tuple[int, int, int]:
    """(channels cw, sequences S, query rows QB) of a tensor-core CTA: the
    widest channel group of :data:`MMA_CHANNELS` dividing D whose staging
    fits; a sequence of up to :data:`MMA_QUERY_ROWS` queries whole (Lq
    rounded up to :data:`MMA_ROW_STEP`), as many of them packed as fill :data:`PACK_BYTES`
    (at most :data:`MAX_PACK`), a longer one in blocks of
    :data:`MMA_QUERY_ROWS` queries, one sequence a CTA."""
    QB = min(_up(Lq, MMA_ROW_STEP), MMA_QUERY_ROWS)
    for cw in MMA_CHANNELS:
        if D % cw or mma_smem_bytes(Lk, cw, 1, QB) > SMEM_BYTES:
            continue
        S = 1
        if Lq <= MMA_QUERY_ROWS:
            S = max(1, min(B, MAX_PACK, PACK_BYTES // mma_smem_bytes(Lk, cw, 1, QB)))
        return cw, S, QB
    raise ValueError(f"dense attention (tensor cores): no channel group of {MMA_CHANNELS} "
                     f"divides D {D} and fits Lk {Lk} in {SMEM_BYTES} bytes")


def dot_product_attention(q, k, v, heads: int, mask=None):
    """flax ``nn.dot_product_attention`` over channel-contiguous heads: q
    scaled by 1/sqrt(hd) and the scores taken in q's dtype, an additive
    bias ``mask`` (broadcast to [Lq, Lk]) added in float32 where given,
    the softmax in float32 cast back to q's dtype, the weighted values in
    q's dtype. q [B, Lq, D], k, v [B, Lk, D] -> [B, Lq, D]."""
    B, Lq, D = q.shape
    hd = D // heads
    dt = q.dtype
    split = lambda a: a.reshape(B, a.shape[1], heads, hd)
    qs = split(q) / trace.upload(hd**0.5, q.device, dt)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, split(k)).float()
    if mask is not None:
        s = s + mask.float()
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p, split(v)).reshape(B, Lq, D)


def check_call(q, k, v, heads: int) -> None:
    """Raise ``ValueError`` unless K15 takes the call (on any device): q
    [B, Lq, D], k and v [B, Lk, D] of q's dtype (float32 or bfloat16), Lq
    and Lk in 1 .. MAX_LEN, D % heads == 0. The kernels take hd
    :data:`HEAD_DIM` alone: :func:`dense_mha` refuses another on CUDA
    tensors."""
    if q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"dense attention: q [B, Lq, D], k and v [B, Lk, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, D = q.shape
    if k.shape[0] != B or k.shape[2] != D or not (1 <= Lq <= MAX_LEN and 1 <= k.shape[1] <= MAX_LEN):
        raise ValueError(f"dense attention: Lq, Lk in 1..{MAX_LEN} and k, v of q's B and D; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if q.dtype not in _cuda.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dense attention: q, k, v float32 or bfloat16, one dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if heads < 1 or D % heads:
        raise ValueError(f"dense attention: D % heads == 0; got D {D}, heads {heads}")


def _dense_mha(q, k, v, heads: int):
    if _cuda.use_plain(q):
        return dot_product_attention(q, k, v, heads)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if D != heads * HEAD_DIM:
        raise ValueError(f"dense attention (CUDA): heads of {HEAD_DIM} channels; got D {D}, "
                         f"heads {heads}")
    _cuda.check(q, "q")
    kstride = _cuda.row_stride(k, "k", k.shape, q.dtype, q.device)
    if _cuda.row_stride(v, "v", v.shape, q.dtype, q.device) != kstride:
        raise ValueError("dense attention: k and v rows must have one spacing")
    path = kernel_path(q.dtype)
    o = torch.empty_like(q)
    qscale = 1.0 / HEAD_DIM**0.5
    if path == "mma":
        if D % 8 or kstride % 8 or any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("dense attention (tensor cores): D and the k/v row spacing "
                             "multiples of 8, q, k, v 16-byte aligned")
        cw, S, QB = mma_plan(B, Lq, Lk, D)
        _cuda.launch("lfsr_dense_mha_mma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), B, Lq, Lk, D, kstride, cw, S, QB, qscale,
                     _cuda.stream_of(q))
    else:
        _cuda.launch("lfsr_dense_mha", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B, Lq, Lk, D, kstride, heads, qscale, _cuda.dtype_code(q, "q"),
                     _cuda.stream_of(q))
    _cuda.launched("K15", path)
    return o


@_cuda.counted("K15", PATHS)
def dense_mha(q, k, v, heads: int):
    """K15, the models' entry: the kernel on CUDA tensors, the plain twin on
    CPU tensors; with a gradient wanted, the twin's gradient."""
    check_call(q, k, v, heads)
    if _cuda.wants_grad(q, k, v):
        return _cuda.PlainVJP.apply("K15", _dense_mha, dot_product_attention, q, k, v, heads)
    return _dense_mha(q, k, v, heads)

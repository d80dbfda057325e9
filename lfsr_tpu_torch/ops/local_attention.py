"""K12 — banded (local-window) multi-head attention over a token grid (LFT).

Port of lfsr_tpu/ops/local_attention.py::local_window_mha, which JAX runs as
XLA ops (no TPU kernel): q, k, v [B, h*w, D] with channel-contiguous heads
(head n owns channels n*hd .. (n+1)*hd, hd = D / heads), token (i, j) at
row i*w + j; each token attends to the k_r x k_c window of tokens (i + di,
j + dj), di in [-(k_r//2), k_r - k_r//2) and dj likewise, and slots outside
the image get exactly zero weight:

    o_h(i, j) = softmax(q_h(i, j) . k_h(window) / sqrt(hd)) . v_h(window)

in float32, returned in q's dtype. LFT's SpaTrans runs it at every block
(5 x 5 over each view's h x w tokens, D = 128, 8 heads of 16).

On CUDA tensors :func:`local_window_mha` launches one of the two kernels of
csrc/local_attention.cu, chosen by :func:`kernel_path` from the dtype:
bfloat16 on the tensor cores (``"mma"``), float32 on the CUDA cores
(``"fma"``). It takes any h, w >= 1, k_r and k_c in 1..:data:`MAX_WINDOW`,
hd in :data:`HEAD_DIMS` and a head count that is a multiple of
:data:`GROUP_CHANNELS` / hd (the tensor-core kernel's CTA holds that many
whole heads), and raises ``ValueError`` for anything else.
``launches/K12`` and ``launches/K12/<path>`` count the launches. On CPU
tensors it runs the plain twin :func:`local_window_plain` (the JAX op's
shifted form). When a gradient is wanted it goes through ``_cuda.PlainVJP``
(kernel forward, the twin's gradient): there is no backward kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import _cuda

HEAD_DIMS = (8, 16, 32)
GROUP_CHANNELS = 64  # channels a CTA of the tensor-core kernel stages: whole heads
MAX_WINDOW = 7
# K12's two kernels, each counted in the trace table as launches/K12/<path>
PATHS = ("mma", "fma")
_NEG = -1e30  # the twin's masked score: large-negative, so its softmax stays NaN-free


def offsets(k_r: int, k_c: int) -> list[tuple[int, int]]:
    """The window's slots (di, dj), row-major."""
    return [(di, dj) for di in range(-(k_r // 2), k_r - k_r // 2)
            for dj in range(-(k_c // 2), k_c - k_c // 2)]


@functools.lru_cache(maxsize=32)
def _valid(h: int, w: int, k_r: int, k_c: int) -> np.ndarray:
    """[h, w, 1, k_r*k_c] bool: slot (di, dj) of token (i, j) inside the image."""
    offs = np.asarray(offsets(k_r, k_c))
    ny = np.arange(h)[:, None, None] + offs[None, None, :, 0]
    nx = np.arange(w)[None, :, None] + offs[None, None, :, 1]
    return ((ny >= 0) & (ny < h) & (nx >= 0) & (nx < w))[:, :, None, :]


@functools.lru_cache(maxsize=32)
def valid_mask(h: int, w: int, k_r: int, k_c: int, device: torch.device) -> torch.Tensor:
    """:func:`_valid` on ``device``, one copy per geometry and device (made
    outside inference mode, so a training step's backward may save it)."""
    with torch.inference_mode(False):
        return trace.upload(_valid(h, w, k_r, k_c), device)


def local_window_plain(q, k, v, heads: int, h: int, w: int, k_r: int, k_c: int):
    """Plain twin of K12, the JAX op's form: q scaled by 1/sqrt(hd), one
    shifted product a slot, the out-of-image slots at -1e30, a softmax over
    the slots, one shifted multiply-add a slot; float32, output in q's
    dtype."""
    B, L, D = q.shape
    hd = D // heads
    f32 = torch.float32
    q4 = (q.to(f32) * (1.0 / hd**0.5)).reshape(B, h, w, heads, hd)
    k4 = k.to(f32).reshape(B, h, w, heads, hd)
    v4 = v.to(f32).reshape(B, h, w, heads, hd)
    ry, rx = k_r // 2, k_c // 2
    py, px = max(ry, k_r - ry - 1), max(rx, k_c - rx - 1)
    kp = F.pad(k4, (0, 0, 0, 0, px, px, py, py))
    vp = F.pad(v4, (0, 0, 0, 0, px, px, py, py))
    offs = offsets(k_r, k_c)
    at = lambda t, di, dj: t[:, py + di : py + di + h, px + dj : px + dj + w]
    scores = torch.stack([(q4 * at(kp, di, dj)).sum(-1) for di, dj in offs], dim=-1)
    scores = torch.where(valid_mask(h, w, k_r, k_c, q.device), scores, _NEG)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    wgt = e / e.sum(-1, keepdim=True)  # [B, h, w, heads, K]
    out = torch.zeros_like(q4)
    for i, (di, dj) in enumerate(offs):
        out = out + wgt[..., i : i + 1] * at(vp, di, dj)
    return out.reshape(B, L, D).to(q.dtype)


def kernel_path(dtype: torch.dtype) -> str:
    """Which K12 kernel takes a call: ``"mma"`` (tensor cores) for
    bfloat16, ``"fma"`` (CUDA cores; float32 stays float32) otherwise."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def check_call(shape, heads: int, h: int, w: int, k_r: int, k_c: int) -> None:
    """Raise ``ValueError`` unless K12 takes q of ``shape`` [B, h*w, D]:
    h, w >= 1, D % heads == 0 with hd in HEAD_DIMS, heads a multiple of
    GROUP_CHANNELS / hd, 1 <= k_r, k_c <= 7."""
    _, L, D = shape
    ok = (h >= 1 and w >= 1 and L == h * w and heads >= 1 and D % heads == 0
          and D // heads in HEAD_DIMS and heads % (GROUP_CHANNELS // (D // heads)) == 0
          and 1 <= k_r <= MAX_WINDOW and 1 <= k_c <= MAX_WINDOW)
    if not ok:
        raise ValueError(f"local window attention kernel takes [B, h*w, D] with h, w >= 1, "
                         f"D % heads == 0, head dim in {HEAD_DIMS}, heads a multiple of "
                         f"{GROUP_CHANNELS} / head dim and a window of 1..{MAX_WINDOW} a side; "
                         f"got {tuple(shape)}, heads={heads}, h={h}, w={w}, window {k_r}x{k_c}")


def _local_window_mha(q, k, v, heads, h, w, k_r, k_c):
    if _cuda.use_plain(q):
        return local_window_plain(q, k, v, heads, h, w, k_r, k_c)
    check_call(q.shape, heads, h, w, k_r, k_c)
    _cuda.dtype_code(q, "q")  # float32 or bfloat16, else ValueError
    _cuda.check(q, "q")
    _cuda.check(k, "k", q.shape, q.dtype, q.device)
    _cuda.check(v, "v", q.shape, q.dtype, q.device)
    B, _, D = q.shape
    o = torch.empty_like(q)
    path = kernel_path(q.dtype)
    if path == "mma" and any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("local window attention (tensor cores): q, k, v must be 16-byte aligned")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, h, w, D, heads, k_r, k_c,
            1.0 / (D // heads) ** 0.5, _cuda.stream_of(q))
    _cuda.launch("lfsr_local_mha_mma" if path == "mma" else "lfsr_local_mha", *args)
    _cuda.launched("K12", path)
    return o


@_cuda.counted("K12", PATHS)
def local_window_mha(q, k, v, heads: int, h: int, w: int, k_r: int, k_c: int):
    """K12: kernel on CUDA tensors, plain twin on CPU tensors. q, k, v
    [B, h*w, D] of one dtype (float32 or bfloat16); differentiable in all
    three."""
    args = (q, k, v, heads, h, w, k_r, k_c)
    if _cuda.wants_grad(q, k, v):
        return _cuda.PlainVJP.apply("K12", _local_window_mha, local_window_plain, *args)
    return _local_window_mha(*args)

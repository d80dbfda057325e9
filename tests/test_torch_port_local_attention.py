"""K12's plain twin (``ops/local_attention.local_window_plain``) against the
JAX op it ports and against a dense masked softmax, on the CPU.

The twin is the JAX op's shifted form in PyTorch; the dense form is
``softmax(q k^T / sqrt(hd) + band mask) v`` over all h*w tokens with the
additive band mask of ``models.epit._band_mask`` (-inf outside each token's
window), which puts zero weight on the slots outside the image by
construction. Geometries: h != w, a side under the window, a 1-pixel side,
the 5x5 window, the even 4x6 one (whose reach is asymmetric) and 7x3, head
dims 8, 16 and 32. float32 within 2e-6 of the output's scale max(1,
max|o|) (the same sums in another order); with bfloat16 operands the twin
computes in float32 and rounds its output to bf16, so within 2^-8 of the
scale of the float32 forms. On CPU
tensors the wrapper ``local_window_mha`` is the twin; it refuses what the
kernel does not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.ops.local_attention import local_window_mha as jax_local_window_mha
from lfsr_tpu_torch.models.epit import _band_mask
from lfsr_tpu_torch.ops import local_attention as la

from _torch_port import one_torch_thread  # noqa: F401

# (B, h, w, heads, hd, k_r, k_c)
CASES = [
    (2, 6, 10, 8, 16, 5, 5),
    (2, 3, 9, 8, 16, 5, 5),
    (1, 10, 2, 4, 8, 5, 5),
    (2, 7, 9, 4, 16, 4, 6),
    (1, 1, 6, 2, 32, 7, 3),
]
_jax_op = jax.jit(jax_local_window_mha, static_argnames=("heads", "h", "w", "k_r", "k_c"))


def _dense(q, k, v, heads, h, w, k_r, k_c):
    B, L, D = q.shape
    hd = D // heads
    split = lambda a: a.float().reshape(B, L, heads, hd)
    s = torch.einsum("bihd,bjhd->bhij", split(q) / hd**0.5, split(k))
    p = torch.softmax(s + torch.from_numpy(_band_mask(h, w, k_r, k_c)), dim=-1)
    return torch.einsum("bhij,bjhd->bihd", p, split(v)).reshape(B, L, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_twin_matches_jax_and_the_dense_masked_softmax(case, dtype):
    B, h, w, heads, hd, k_r, k_c = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (torch.from_numpy(1.5 * rng.standard_normal((B, h * w, heads * hd),
                                                            dtype=np.float32)).to(dtype)
               for _ in range(3))
    got = la.local_window_mha(q, k, v, heads, h, w, k_r, k_c)
    assert got.dtype == dtype and torch.equal(got, la.local_window_plain(q, k, v, heads, h, w,
                                                                         k_r, k_c))
    dense = _dense(q, k, v, heads, h, w, k_r, k_c)
    want = np.asarray(_jax_op(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                              heads=heads, h=h, w=w, k_r=k_r, k_c=k_c))
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(dense.numpy(), want, atol=2e-6 * scale, rtol=0)
    tol = (2e-6 if dtype == torch.float32 else 2.0**-8) * scale
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_out_of_image_slots_take_no_weight():
    """Values at the border that no in-window slot reaches do not move the
    output, and a corner token of a 1 x 1 window returns its own value."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 36, 16), dtype=np.float32))
               for _ in range(3))
    out = la.local_window_plain(q, k, v, 1, 6, 6, 1, 1)
    torch.testing.assert_close(out, v, atol=1e-6, rtol=0)
    v2 = v.clone().reshape(1, 6, 6, 16)
    v2[:, 5, 5] += 100.0  # the far corner: outside token (0, 0)'s 5 x 5 window
    base = la.local_window_plain(q, k, v, 2, 6, 6, 5, 5).reshape(1, 6, 6, 16)
    moved = la.local_window_plain(q, k, v2.reshape(1, 36, 16), 2, 6, 6, 5, 5).reshape(1, 6, 6, 16)
    assert torch.equal(base[:, 0, 0], moved[:, 0, 0])


@pytest.mark.parametrize("shape,heads,h,w,k_r,k_c", [
    ((2, 64, 48), 8, 8, 8, 5, 5),    # head dim 6
    ((2, 64, 512), 8, 8, 8, 5, 5),   # head dim 64
    ((2, 64, 128), 8, 8, 8, 8, 5),   # window 8
    ((2, 64, 128), 8, 8, 7, 5, 5),   # h * w != L
    ((2, 64, 48), 3, 8, 8, 5, 5),    # 3 heads of 16: not whole 64-channel groups
    ((2, 64, 32), 4, 8, 8, 5, 5),    # 4 heads of 8
])
def test_the_kernel_call_is_refused_outside_what_it_takes(shape, heads, h, w, k_r, k_c):
    with pytest.raises(ValueError):
        la.check_call(shape, heads, h, w, k_r, k_c)
    la.check_call((2, 64, 128), 8, 8, 8, 5, 5)  # LFT's: taken

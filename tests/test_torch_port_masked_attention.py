"""Port vs JAX: K8, the banded-mask multi-head attention (EPIT).

The port's plain twin ``masked_mha_plain`` and its wrapper
``masked_mha_fused`` (which takes the twin on CPU tensors) against the JAX
package's ``masked_mha_fused`` — its Pallas kernel, in interpret mode on
the CPU — and its reference ``masked_mha_ref``, on the same numpy inputs.

Tolerances: float32 1e-5 (sums in another order; the JAX kernel's
head-masked stacked product adds zeros, the twin contracts each head
alone); bf16 I/O 2e-2 (one bf16 rounding of an O(1) output); gradients
1e-4 (float32 backward through the softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.models import epit as jepit
from lfsr_tpu.ops import pallas_masked_attention as jma
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.models import epit
from lfsr_tpu_torch.ops import masked_attention as ma


def _band(L, width=11):
    i = np.arange(L)
    return np.where(np.abs(i[None, :] - i[:, None]) <= width // 2, 0.0, -np.inf).astype(np.float32)


def _qkv(B=8, L=32, D=128, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3)]


def _jax(fn, qkv, mask, heads, dtype=jnp.float32):
    q, k, v = (jnp.asarray(a, dtype) for a in qkv)
    if fn is jma.masked_mha_fused:
        out = fn(q, k, v, jnp.asarray(mask), heads)
    else:
        out = fn(q, k, v, jnp.asarray(mask), heads=heads)
    return np.asarray(out.astype(jnp.float32))


def _port(fn, qkv, mask, heads, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in qkv)
    return fn(q, k, v, torch.from_numpy(mask), heads)


@pytest.mark.parametrize("heads", [4, 8])
def test_twin_and_wrapper_match_the_pallas_kernel_and_reference(heads):
    qkv, mask = _qkv(), _band(32)
    kernel = _jax(jma.masked_mha_fused, qkv, mask, heads)
    ref = _jax(jma.masked_mha_ref, qkv, mask, heads)
    for fn in (ma.masked_mha_plain, ma.masked_mha_fused):
        got = _port(fn, qkv, mask, heads)
        assert got.dtype == torch.float32 and got.shape == (8, 32, 128)
        np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_bf16_io():
    qkv, mask = _qkv(seed=3), _band(32)
    want = _jax(jma.masked_mha_fused, qkv, mask, 8, jnp.bfloat16)
    got = _port(ma.masked_mha_fused, qkv, mask, 8, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("h", [8, 32], ids=["L40", "L160"])
def test_epit_masks(h):
    """EPIT's own masks: 5 angular rows (band 10, all of them) x h spatial
    columns (band 11), L = 5 h; the port's mask equals the JAX module's."""
    mask = epit._band_mask(5, h, 10, 11)
    np.testing.assert_array_equal(mask, jepit._band_mask(5, h, 10, 11))
    qkv = _qkv(B=4, L=5 * h, seed=4)
    want = _jax(jma.masked_mha_fused, qkv, mask, 8)
    got = _port(ma.masked_mha_fused, qkv, mask, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_supported_equals_jax():
    grid = [(L, D, heads) for L in (8, 37, 40, 160, 512, 513, 520, 1024)
            for D in (64, 96, 128, 256, 384) for heads in (1, 3, 4, 8, 16)]
    assert [ma.supported(*g) for g in grid] == [jma.supported(*g) for g in grid]
    assert ma.supported(160, 128, 8)  # EPIT at full width


def test_gradients_match_jax_grad():
    qkv, mask = _qkv(B=2, L=16, seed=2), _band(16, width=7)
    cot = np.random.default_rng(9).standard_normal((2, 16, 128)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jma.masked_mha_fused(q, k, v, jnp.asarray(mask), 8) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv))
    leaves = [torch.from_numpy(a).requires_grad_() for a in qkv]
    launches = trace.counter("launches/K8")
    out = ma.masked_mha_fused(*leaves, torch.from_numpy(mask), 8)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    assert trace.counter("launches/K8") == launches  # CPU tensors: the twin, no launch
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_wrapper_refuses_a_device_it_has_no_path_for():
    """Neither a CPU tensor (the twin) nor a CUDA one (the kernel): the
    wrapper raises rather than pick a path."""
    q = torch.empty(2, 16, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ma.masked_mha_fused(q, q, q, torch.empty(16, 16, device="meta"), 8)

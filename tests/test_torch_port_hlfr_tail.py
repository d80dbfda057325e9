"""Port vs JAX: the HLFR tail (K10) on the CPU.

The JAX side runs as its own tests run it (tests/test_pallas_head.py):
``pallas_head.hlfr_tail`` is the Pallas kernel in interpret mode with
``FORCE_KERNEL_INTERPRET`` set by a fixture and restored after, and
``hlfr_tail_ref`` is the reference chain. The port's ``head.hlfr_tail``
takes its plain twin on CPU tensors and counts no launch.

Tolerances (absolute; outputs are ~1): bf16 2e-3 (the Pallas kernel's
test against its reference: the z and taps sums in another order, one
bf16 ulp of z here and there), float32 1e-5 (sums in another order); the
gradient 1e-4 (as JAX's own gradient test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.models.lfmambax import _fold_out_conv
from lfsr_tpu.ops import pallas_head as jph
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.models.lfmambax import fold_out_conv
from lfsr_tpu_torch.ops import head

from _torch_port import one_torch_thread  # noqa: F401


@pytest.fixture
def tail_interpret():
    jph.FORCE_KERNEL_INTERPRET = True
    yield
    jph.FORCE_KERNEL_INTERPRET = False


def _inputs(H, W, C=16, r=2, seed=0):
    """y [2, H, W, C], w1 [C, C r r], the folded kf of a 3x3 kernel, bias [1]
    (float32 numpy; rounded to bf16 by the caller where wanted)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, H, W, C)).astype(np.float32),
            (rng.standard_normal((C, C * r * r)) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, C, 1)) * 0.1).astype(np.float32),
            np.asarray([0.3], np.float32))


def _pair(y, w1, k3, bias, dtype, r=2):
    """(JAX args, port args) in ``dtype`` ("float32" or "bfloat16"), kf
    folded on each side from the same k3."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jw, jk, jb = (jnp.asarray(a, jdt) for a in (y, w1, k3, bias))
    ty, tw, tk, tb = (torch.from_numpy(a).to(tdt) for a in (y, w1, k3, bias))
    return (jy, jw, _fold_out_conv(jk, r), jb), (ty, tw, fold_out_conv(tk, r), tb)


def test_cpu_hlfr_tail_matches_the_pallas_kernel_bf16(tail_interpret):
    jargs, targs = _pair(*_inputs(32, 32), "bfloat16")
    want = np.asarray(jph.hlfr_tail(*jargs), np.float32)
    before = trace.counter("launches/K10")
    got = head.hlfr_tail(*targs)
    assert trace.counter("launches/K10") == before
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_cpu_hlfr_tail_matches_the_reference_non_square(dtype, tol):
    jargs, targs = _pair(*_inputs(24, 40, seed=1), dtype)
    want = np.asarray(jph.hlfr_tail_ref(*jargs), np.float32)
    got = head.hlfr_tail(*targs)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 40, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_hlfr_tail_gradient_matches_jax_grad(tail_interpret):
    """The gradient of every operand through ``_cuda.PlainVJP`` (the twin's)
    against ``jax.grad`` of the custom_vjp ``hlfr_tail`` (the reference's),
    float32, under a random cotangent (square: the Pallas kernel is)."""
    y, w1, k3, bias = _inputs(16, 16, seed=2)
    kf = np.array(_fold_out_conv(jnp.asarray(k3), 2))
    cot = np.random.default_rng(3).standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jph.hlfr_tail(*a) * cot), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (y, w1, kf, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (y, w1, kf, bias)]
    got = torch.autograd.grad(head.hlfr_tail(*leaves), leaves, torch.from_numpy(cot))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)

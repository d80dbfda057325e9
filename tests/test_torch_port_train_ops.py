"""Port vs JAX: gradients of the block kernels' Functions and the losses.

K4-K7 have no backward kernel in the JAX package: their custom_vjps
differentiate the XLA reference, and the port's autograd Functions
differentiate the plain twin. Here the JAX side runs the kernels in
interpret mode (``FORCE_KERNEL_INTERPRET``, set by a fixture; K6 interprets
off the TPU by itself) and ``jax.grad`` goes through each custom_vjp; the
port's wrappers run on CPU tensors (twin forward, twin gradient). Every
loss term of ``composite_v8`` and the composite itself: value and gradient
in sr. All float32. Tolerances: 1e-5 relative to max(1, max|want|) (float32
sums in another order; the FFT term 1e-4, a 40-point transform summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.config import Config
from lfsr_tpu.models import losses as jlosses
from lfsr_tpu.ops import pallas_attention as jpa
from lfsr_tpu.ops import pallas_block as jpb
from lfsr_tpu.ops import pallas_layout as jpl
from lfsr_tpu_torch.models import losses
from lfsr_tpu_torch.models.registry import get_loss
from lfsr_tpu_torch.ops import block, cross_scan, window_attention

from _torch_port import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(11)


@pytest.fixture
def interpret():
    jpl.FORCE_KERNEL_INTERPRET = jpb.FORCE_KERNEL_INTERPRET = True
    yield
    jpl.FORCE_KERNEL_INTERPRET = jpb.FORCE_KERNEL_INTERPRET = False


def _rn(*shape, s=1.0):
    return (RNG.standard_normal(shape) * s).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.size == want.size, (got.shape, want.shape)
    err = np.abs(got.reshape(want.shape) - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _cases():
    C, S, T, c4 = 16, 16, 64, 4
    x = _rn(2, S, S, C)
    return {
        "K4": (cross_scan.cross_scan_gather, jpl.cross_scan_gather,
               [x, 1 + _rn(C, s=0.2), _rn(C, s=0.1)], {}),
        "K5": (cross_scan.cross_scan_scatter, jpl.cross_scan_scatter,
               [_rn(2, S * S, C), x, _rn(C, C, s=0.3), np.full((1,), 0.15, np.float32)], {}),
        "K6": (window_attention.window_mha_fused, jpa.window_mha_fused,
               [x, _rn(C, 3 * C, s=C**-0.5), _rn(C, C, s=C**-0.5), 1 + _rn(C, s=0.2),
                _rn(C, s=0.1), _rn(T, 4 * T, s=0.1), np.full((1,), 0.25, np.float32)],
               dict(ws=8, heads=4, eps=1e-6)),
        "K7": (block.ln_msl, jpb.ln_msl,
               [x, 1 + _rn(C, s=0.2), _rn(C, s=0.1), _rn(c4, C, s=0.3), _rn(C - c4, C, s=0.3),
                _rn(3, 3, C - c4, s=0.3)], {}),
    }


@pytest.mark.parametrize("name", ["K4", "K5", "K6", "K7"])
def test_kernel_function_gradients_match_jax(interpret, name):
    port_fn, jax_fn, args, kw = _cases()[name]
    outs = jax.eval_shape(lambda *a: jax_fn(*a, **kw), *map(jnp.asarray, args))
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    cot = [_rn(*o.shape) for o in outs]

    def jloss(*a):
        y = jax_fn(*a, **kw)
        y = y if isinstance(y, (tuple, list)) else (y,)
        return sum(jnp.sum(o * c) for o, c in zip(y, cot))

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = port_fn(*targs, *kw.values())
    y = y if isinstance(y, tuple) else (y,)
    assert all(type(o.grad_fn).__name__ == "PlainVJPBackward" for o in y)
    got = torch.autograd.grad(y, targs, [torch.from_numpy(c) for c in cot])
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5)


def _loss_pairs():
    cfg = Config()
    return {
        "l1": (losses.l1, jlosses.l1, 1e-5),
        "charbonnier": (losses.charbonnier, jlosses.charbonnier, 1e-5),
        "fft_magnitude_l1": (losses.fft_magnitude_l1, jlosses.fft_magnitude_l1, 1e-4),
        "ssim_loss": (losses.ssim_loss, jlosses.ssim_loss, 1e-5),
        "gradient_l1": (losses.gradient_l1, jlosses.gradient_l1, 1e-5),
        "angular_consistency": (lambda s, h: losses.angular_consistency(s, h, 5),
                                lambda s, h: jlosses.angular_consistency(s, h, 5), 1e-5),
        "composite_v8": (get_loss(cfg), jlosses.composite_v8_builder(cfg), 1e-4),
    }


@pytest.mark.parametrize("name", list(_loss_pairs()))
def test_loss_value_and_gradient_match_jax(name):
    port_fn, jax_fn, rel = _loss_pairs()[name]
    hr = RNG.random((2, 40, 40, 1)).astype(np.float32)
    sr = np.clip(hr + _rn(2, 40, 40, 1, s=0.1), 0, 1)
    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(sr), jnp.asarray(hr))
    tsr = torch.from_numpy(sr).requires_grad_()
    got = port_fn(tsr, torch.from_numpy(hr))
    assert got.dtype == torch.float32 and got.dim() == 0
    (got_g,) = torch.autograd.grad(got, tsr)
    _close(got.item(), want, rel)
    _close(got_g.numpy(), want_g, rel)


def test_losses_compute_in_float32_from_bfloat16():
    hr = torch.rand(1, 20, 20, 1, generator=torch.Generator().manual_seed(0))
    sr = (hr + 0.05).to(torch.bfloat16)
    loss = get_loss(Config())
    assert loss(sr, hr).dtype == torch.float32
    np.testing.assert_allclose(loss(sr, hr).item(), loss(sr.float(), hr).item(), rtol=1e-6)

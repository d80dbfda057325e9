"""Port vs JAX: layouts, bicubic residual, tiling and metrics (float32).

Inputs come from numpy with a fixed seed and go through the JAX function
and its ``lfsr_tpu_torch`` counterpart. Layouts and tiling are pure data
movement, so they must agree exactly; resize and metrics are float32
arithmetic in a different operation order (tolerances stated per test).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lfsr_tpu.ops import layout as jl
from lfsr_tpu.ops import metrics as jmet
from lfsr_tpu.ops import tiling as jt
from lfsr_tpu.ops.resize import interpolate as j_interpolate
from lfsr_tpu_torch.ops import layout as tl
from lfsr_tpu_torch.ops import metrics as tmet
from lfsr_tpu_torch.ops import tiling as tt
from lfsr_tpu_torch.ops.resize import interpolate as t_interpolate

from _torch_port import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(7)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fn", ["sai_to_macpi", "macpi_to_sai", "sai_to_views"])
def test_layout_matches_jax(fn):
    x = RNG.random((2, 3, 5 * 6, 5 * 4)).astype(np.float32)
    jx, tx = _pair(x)
    want = np.asarray(getattr(jl, fn)(jx, 5))
    got = getattr(tl, fn)(tx, 5).numpy()
    np.testing.assert_array_equal(got, want)


def test_views_to_sai_matches_jax():
    x = RNG.random((2, 5, 5, 6, 4)).astype(np.float32)
    jx, tx = _pair(x)
    np.testing.assert_array_equal(tl.views_to_sai(tx).numpy(), np.asarray(jl.views_to_sai(jx)))


def test_interpolate_matches_jax():
    # both are torch's bicubic (align_corners=False); the JAX dense plan is
    # pinned to F.interpolate at 2e-6 by tests/test_resize.py
    x = RNG.random((2, 1, 40, 40)).astype(np.float32)
    jx, tx = _pair(x)
    want = np.asarray(j_interpolate(jx, 4))
    got = t_interpolate(tx, 4).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("h0,w0,patch,stride", [(16, 16, 8, 4), (13, 17, 8, 4), (128, 128, 32, 16)])
def test_tiling_matches_jax(h0, w0, patch, stride):
    ang = 5
    assert tt.tile_counts(h0, w0, patch, stride) == jt.tile_counts(h0, w0, patch, stride)
    sai = RNG.random((ang * h0, ang * w0)).astype(np.float32)
    jx, tx = _pair(sai)
    want = np.asarray(jt.lf_divide(jx, ang, patch, stride))
    got = tt.lf_divide(tx, ang, patch, stride).numpy()
    np.testing.assert_array_equal(got, want)
    # integrate in output pixels (scale 2): patches of 2*patch, stride 2*stride
    sr = RNG.random((got.shape[0], ang * 2 * patch, ang * 2 * patch)).astype(np.float32)
    js, ts = _pair(sr)
    want_i = np.asarray(jt.lf_integrate(js, ang, 2 * patch, 2 * stride, 2 * h0, 2 * w0))
    got_i = tt.lf_integrate(ts, ang, 2 * patch, 2 * stride, 2 * h0, 2 * w0).numpy()
    np.testing.assert_array_equal(got_i, want_i)


def test_divide_integrate_roundtrip_is_identity():
    sai = torch.from_numpy(RNG.random((5 * 20, 5 * 20)).astype(np.float32))
    p = tt.lf_divide(sai, 5, 8, 4)
    views = tt.lf_integrate(p, 5, 8, 4, 20, 20)
    np.testing.assert_array_equal(tl.views_to_sai(views).numpy(), sai.numpy())


def test_metrics_match_jax():
    # float32 with a different sum order (shifted adds vs XLA conv):
    # PSNR to 1e-4 dB, SSIM to 1e-5
    hr = RNG.random((5 * 24, 5 * 24)).astype(np.float32)
    sr = np.clip(hr + 0.05 * RNG.standard_normal(hr.shape), 0, 1).astype(np.float32)
    jp, js = jmet.lf_metrics(jnp.asarray(hr), jnp.asarray(sr), 5)
    tp, ts = tmet.lf_metrics(torch.from_numpy(hr), torch.from_numpy(sr), 5)
    assert abs(float(tp) - float(jp)) < 1e-4
    assert abs(float(ts) - float(js)) < 1e-5
    jv = jl.sai_to_views(jnp.asarray(hr), 5)
    sv = jl.sai_to_views(jnp.asarray(sr), 5)
    np.testing.assert_allclose(
        tmet.ssim(tl.sai_to_views(torch.from_numpy(hr), 5),
                  tl.sai_to_views(torch.from_numpy(sr), 5)).numpy(),
        np.asarray(jmet.ssim(jv, sv)), atol=1e-5,
    )

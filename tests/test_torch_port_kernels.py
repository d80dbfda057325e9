"""Port vs JAX: each kernel's plain twin against the JAX kernel function.

The JAX side runs as its own tests run it on the CPU: the K1 scan and K6
window-attention Pallas kernels in interpret mode (automatic off the TPU),
the K4/K5 cross-scan kernels in interpret mode via
``pallas_layout.FORCE_KERNEL_INTERPRET`` (set and restored by a fixture).
K7 (``ln_msl``) and K10 (``hlfr_tail``, retired on the TPU) are held against
their JAX reference forms. All in float32. Tolerances: data movement + LayerNorm
+ attention <= 1e-5 (float32 sums in another order); the scan <= 1e-4
relative (exp and the recurrence's sums in another order).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lfsr_tpu.models import lfmambax as jlfm
from lfsr_tpu.ops import pallas_attention as jpa
from lfsr_tpu.ops import pallas_block as jpb
from lfsr_tpu.ops import pallas_head as jph
from lfsr_tpu.ops import pallas_layout as jpl
from lfsr_tpu.ops import pallas_scan as jps
from lfsr_tpu.ops import selective_scan as jss
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.models import lfmambax as tlfm
from lfsr_tpu_torch.ops import block, cross_scan, head, scan, selective_scan, window_attention

RNG = np.random.default_rng(3)


@pytest.fixture
def layout_interpret():
    jpl.FORCE_KERNEL_INTERPRET = True
    yield
    jpl.FORCE_KERNEL_INTERPRET = False


def _rn(*shape, s=1.0):
    return (RNG.standard_normal(shape) * s).astype(np.float32)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _scan_inputs(B=2, L=256, Di=12, N=4, R=2):
    u = _rn(B, L, Di, s=0.5)
    dbc = _rn(B, L, R + 2 * N, s=0.5)
    Wdt, bdt = _rn(R, Di, s=0.3), _rn(Di, s=0.1)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (Di, 1))
    D = np.ones(Di, np.float32) + _rn(Di, s=0.1)
    return u, dbc, Wdt, bdt, A, D


def _assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def test_selective_scan_plain_matches_jax():
    u, dbc, Wdt, bdt, A, D = _scan_inputs(L=100)
    delta = np.log1p(np.exp(_rn(*u.shape, s=0.5)))
    Bc, Cc = dbc[..., 2:6], dbc[..., 6:]
    want = jss.selective_scan_sequential(*_j(u, delta, A, Bc, Cc, D))
    got = selective_scan.selective_scan(*_t(u, delta, A, Bc, Cc, D))
    _assert_rel(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("L", [128, 256])
def test_k1_plain_twin_matches_pallas_kernel(L):
    args = _scan_inputs(L=L)
    want = jps.selective_scan_proj(*_j(*args), 128)  # Pallas kernel, interpret mode
    got = scan.selective_scan_proj_plain(*_t(*args))
    _assert_rel(got.numpy(), want, 1e-4)
    _assert_rel(got.numpy(), jps.scan_proj_ref(*_j(*args)), 1e-4)


def test_k1_wrapper_takes_twin_on_cpu_without_counting():
    args = _t(*_scan_inputs(L=64))
    before = trace.counter("launches/K1")
    got = scan.selective_scan_proj(*args)
    assert trace.counter("launches/K1") == before
    np.testing.assert_array_equal(got.numpy(), scan.selective_scan_proj_plain(*args).numpy())


@pytest.mark.parametrize("S,C", [(16, 8), (24, 16)])
def test_k4_plain_twin_matches_pallas_kernel(layout_interpret, S, C):
    x, g, b = _rn(2, S, S, C), 1 + _rn(C, s=0.2), _rn(C, s=0.1)
    want = jpl.cross_scan_gather(*_j(x, g, b))
    got = cross_scan.cross_scan_gather(*_t(x, g, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_k4_k5_plain_twins_match_reference_on_non_square_maps():
    x, g, b = _rn(2, 12, 20, 8), 1 + _rn(8, s=0.2), _rn(8, s=0.1)
    np.testing.assert_allclose(
        cross_scan.cross_scan_gather_plain(*_t(x, g, b)).numpy(),
        np.asarray(jpl.cross_scan_gather_ref(*_j(x, g, b))), atol=1e-5, rtol=0)
    seq, w, sc = _rn(2, 240, 8), _rn(8, 8, s=0.3), np.full((1,), 0.15, np.float32)
    np.testing.assert_allclose(
        cross_scan.cross_scan_scatter_plain(*_t(seq, x, w, sc)).numpy(),
        np.asarray(jpl.cross_scan_scatter_ref(*_j(seq, x, w, sc))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("S,C", [(16, 8), (24, 16)])
def test_k5_plain_twin_matches_pallas_kernel(layout_interpret, S, C):
    seq, x = _rn(2, S * S, C), _rn(2, S, S, C)
    w, sc = _rn(C, C, s=0.3), np.full((1,), 0.15, np.float32)
    want = jpl.cross_scan_scatter(*_j(seq, x, w, sc))
    got = cross_scan.cross_scan_scatter(*_t(seq, x, w, sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_k4_k5_twins_are_inverse_permutations():
    x = torch.from_numpy(_rn(1, 8, 12, 8))
    seq = cross_scan._permute(x)
    np.testing.assert_array_equal(cross_scan._unpermute(seq, 8, 12).numpy(), x.numpy())


@pytest.mark.parametrize("H,W,C", [(16, 24, 16), (8, 8, 32)])
def test_k6_plain_twin_matches_pallas_kernel(H, W, C):
    ws, heads, T = 8, 4, 64
    x = _rn(2, H, W, C)
    wqkv, wout = _rn(C, 3 * C, s=C**-0.5), _rn(C, C, s=C**-0.5)
    g, b = 1 + _rn(C, s=0.2), _rn(C, s=0.1)
    bias, sc = _rn(T, heads * T, s=0.1), np.full((1,), 0.25, np.float32)
    jargs = _j(x, wqkv, wout, g, b, bias)
    want = jpa.window_mha_fused(*jargs, jnp.asarray(0.25), ws, heads, 1e-6)
    got = window_attention.window_mha_fused(*_t(x, wqkv, wout, g, b, bias, sc), ws, heads, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_k7_plain_math_matches_jax_reference():
    C, c4 = 16, 4
    x, g, b = _rn(2, 12, 12, C), 1 + _rn(C, s=0.2), _rn(C, s=0.1)
    whm, wrest, wk = _rn(c4, C, s=0.3), _rn(C - c4, C, s=0.3), _rn(3, 3, C - c4, s=0.3)
    jxn, jloc = jpb.ln_msl_ref(*_j(x, g, b, whm, wrest, wk))
    txn, tloc = block.ln_msl_plain(*_t(x, g, b, whm, wrest, wk))
    np.testing.assert_allclose(txn.numpy(), np.asarray(jxn), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tloc.numpy(), np.asarray(jloc), atol=1e-5, rtol=0)


def test_hlfr_tail_and_fold_match_jax():
    C, r = 8, 2
    y, w1 = _rn(2, 10, 10, C), _rn(C, C * r * r, s=0.3)
    k3, bias = _rn(3, 3, C, 1, s=0.3), _rn(1, s=0.1)
    jkf = jlfm._fold_out_conv(jnp.asarray(k3), r)
    tkf = tlfm.fold_out_conv(torch.from_numpy(k3), r)
    np.testing.assert_array_equal(tkf.numpy(), np.asarray(jkf))
    want = jph.hlfr_tail_ref(*_j(y, w1), jkf, jnp.asarray(bias), 0.1)
    got = head.hlfr_tail_plain(*_t(y, w1), tkf, torch.from_numpy(bias), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

"""Port vs JAX: the chunked scan, the twins' switch to it, and K9a's op.

- ``selective_scan.selective_scan_chunked`` against JAX's, forward and the
  gradients of all six operands (float32, chunk 64 over L 512).
- ``scan.selective_scan_fused`` (K9a; its twin on CPU tensors) against
  JAX's ``pallas_scan.selective_scan_fused``, which runs its Pallas kernel
  in interpret mode off the TPU (as tests/test_pallas_scan.py runs it):
  ``pre_softplus`` both ways, D_skip None and given, float32 and bf16. In
  bf16 the output is rounded twice (y, then y + u D); the twin must agree
  with the kernel element for element nearly everywhere, which one
  rounding does not. Its gradient (the chunked scan's, D inside) against
  ``jax.grad`` of the custom_vjp.
- The twins of K1, K9b and K9c at L = 17 x 256 = 4352 (> 4096) take the
  chunked branch, as JAX's references do, and match them.

Tolerances, against max(1, max|want|): float32 1e-5 (sums in another
order); bf16 2e-2 (the scan's float32 sums in another order move a few
outputs across a bf16 rounding boundary: one ulp); gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.ops import pallas_scan as jps
from lfsr_tpu.ops import selective_scan as jss
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import scan, selective_scan

from _torch_port import one_torch_thread  # noqa: F401


def _rn(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _scan_inputs(seed, B=2, L=512, Di=8, N=4):
    """u, delta (post-softplus), A, Bc, Cc, D."""
    rng = np.random.default_rng(seed)
    return (_rn(rng, B, L, Di, s=0.5), np.log1p(np.exp(_rn(rng, B, L, Di, s=0.5))),
            -np.abs(_rn(rng, Di, N)) - 0.1, _rn(rng, B, L, N, s=0.5), _rn(rng, B, L, N, s=0.5),
            1 + _rn(rng, Di, s=0.1))


def _assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


# (a) the chunked scan ---------------------------------------------------------

def test_selective_scan_chunked_matches_jax():
    args = _scan_inputs(0)
    want = jss.selective_scan_chunked(*map(jnp.asarray, args), chunk=64)
    got = selective_scan.selective_scan_chunked(*map(torch.from_numpy, args), chunk=64)
    assert got.dtype == torch.float32 and got.shape == (2, 512, 8)
    _assert_rel(got.numpy(), want, 1e-5)


def test_selective_scan_chunked_gradients_match_jax_grad():
    args = _scan_inputs(1)
    cot = np.random.default_rng(2).standard_normal((2, 512, 8)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jss.selective_scan_chunked(*a, chunk=64) * cot),
                    argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(selective_scan.selective_scan_chunked(*leaves, chunk=64), leaves,
                              torch.from_numpy(cot))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _assert_rel(g.numpy(), w, 1e-5)


def test_selective_scan_chunked_rejects_a_ragged_length():
    args = [torch.from_numpy(a) for a in _scan_inputs(3, L=200)]
    with pytest.raises(ValueError, match="not divisible"):
        selective_scan.selective_scan_chunked(*args, chunk=64)


# (b) K9a: selective_scan_fused ---------------------------------------------------

def _fused_pair(seed, dtype, with_d, pre_softplus, L=256):
    """JAX and port operands: u, delta (pre-softplus values when asked), Bc, Cc
    in ``dtype``; A and D float32."""
    u, delta, A, Bc, Cc, D = _scan_inputs(seed, L=L)
    if pre_softplus:
        delta = np.log(np.expm1(delta))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(u, jdt), jnp.asarray(delta, jdt), jnp.asarray(A), jnp.asarray(Bc, jdt),
         jnp.asarray(Cc, jdt), jnp.asarray(D) if with_d else None]
    t = [torch.from_numpy(u).to(tdt), torch.from_numpy(delta).to(tdt), torch.from_numpy(A),
         torch.from_numpy(Bc).to(tdt), torch.from_numpy(Cc).to(tdt),
         torch.from_numpy(D) if with_d else None]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_d", [False, True], ids=["no_d", "d"])
@pytest.mark.parametrize("pre_softplus", [False, True], ids=["delta", "dt_raw"])
def test_cpu_selective_scan_fused_matches_the_pallas_kernel(dtype, with_d, pre_softplus):
    j, t = _fused_pair(4, dtype, with_d, pre_softplus)
    want = np.asarray(jps.selective_scan_fused(*j, 64, pre_softplus).astype(jnp.float32))
    before = trace.counter("launches/K9a")
    got = scan.selective_scan_fused(*t, 64, pre_softplus)
    assert trace.counter("launches/K9a") == before
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 256, 8)
    _assert_rel(got.float().numpy(), want, 1e-5 if dtype == "float32" else 2e-2)


def test_bf16_selective_scan_fused_rounds_twice_as_jax():
    """y rounded to bf16, then y + u D rounded again: the twin equals JAX's
    kernel on all but a few outputs (the float32 scans differ in the last
    bits); rounding once (D inside the scan) moves a large share of them."""
    j, t = _fused_pair(5, "bfloat16", True, True)
    want = np.asarray(jps.selective_scan_fused(*j, 64, True).astype(jnp.float32))
    got = scan.selective_scan_fused(*t, 64, True).float().numpy()
    once = selective_scan.selective_scan_chunked(
        t[0], scan.softplus(t[1].float()), *t[2:], 64).float().numpy()
    assert (got != want).mean() <= 1e-3, (got != want).mean()
    assert (once != want).mean() >= 0.1, (once != want).mean()


@pytest.mark.parametrize("pre_softplus", [False, True], ids=["delta", "dt_raw"])
def test_selective_scan_fused_gradients_match_jax_grad(pre_softplus):
    j, t = _fused_pair(6, "float32", True, pre_softplus, L=256)
    cot = np.random.default_rng(7).standard_normal((2, 256, 8)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jps.selective_scan_fused(*a, 64, pre_softplus) * cot),
                    argnums=tuple(range(6)))(*j)
    leaves = [a.requires_grad_() for a in t]
    got = torch.autograd.grad(scan.selective_scan_fused(*leaves, 64, pre_softplus), leaves,
                              torch.from_numpy(cot))
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w, 1e-5)


def test_selective_scan_fused_gradient_keeps_the_chunk_rule():
    """JAX's gradient asserts L % chunk == 0 (the chunked reference); the
    forward takes any L."""
    _, t = _fused_pair(8, "float32", True, False, L=200)
    leaves = [a.requires_grad_() for a in t]
    y = scan.selective_scan_fused(*leaves, 64)
    assert y.shape == (2, 200, 8)
    with pytest.raises(ValueError, match="not divisible"):
        y.sum().backward()


# (c) the twins take the chunked scan where JAX's references do ---------------------

@pytest.fixture
def chunked_calls(monkeypatch):
    """Counts the twins' calls of the chunked scan."""
    calls = []
    real = scan.selective_scan_chunked

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(scan, "selective_scan_chunked", spy)
    return calls


@pytest.mark.parametrize("name", ["K1", "K9b", "K9c"])
def test_twins_at_a_long_length_take_the_chunked_scan(chunked_calls, name):
    L = 17 * 256  # > 4096 and a multiple of 256
    rng = np.random.default_rng(9)
    Di, N, R = 8, 4, 2
    A = -np.abs(_rn(rng, Di, N)) - 0.1
    D = 1 + _rn(rng, Di, s=0.1)
    if name == "K1":  # u, dbc, Wdt, bdt, A, D
        args = (_rn(rng, 1, L, Di, s=0.5), _rn(rng, 1, L, R + 2 * N, s=0.5), _rn(rng, R, Di, s=0.3),
                _rn(rng, Di, s=0.1), A, D)
        jfn, tfn = jps.scan_proj_ref, scan.selective_scan_proj_plain
    elif name == "K9b":  # u, dt_raw, A, Bc, Cc, z, D, Wout
        args = (_rn(rng, 1, L, Di, s=0.5), _rn(rng, 1, L, Di, s=0.5), A, _rn(rng, 1, L, N, s=0.5),
                _rn(rng, 1, L, N, s=0.5), _rn(rng, 1, L, Di), D, _rn(rng, Di, 6, s=Di**-0.5))
        jfn = lambda *a: jps.scan_gated_ref(*a, pre_softplus=True)
        tfn = lambda *a: scan.scan_gated_plain(*a, pre_softplus=True)
    else:  # xs, z, wconv, bconv, Wx, Wdt, bdt, A, D
        args = (_rn(rng, 1, L, Di), _rn(rng, 1, L, Di), _rn(rng, 4, Di, s=0.2), _rn(rng, Di, s=0.1),
                _rn(rng, Di, R + 2 * N, s=0.1), _rn(rng, R, Di, s=0.2), _rn(rng, Di, s=0.1), A, D)
        jfn, tfn = jps.mamba_inner_ref, scan.mamba_inner_plain
    want = jfn(*map(jnp.asarray, args))
    got = tfn(*map(torch.from_numpy, args))
    assert chunked_calls == [(1, L, Di)]
    _assert_rel(got.numpy(), want, 1e-5)

"""Port vs JAX: the scan's training forward (K2), its adjoint (K3) and the
differentiable scan (the custom_vjp of ``selective_scan_proj``).

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
on the CPU, at a multi-block geometry: B 2, L 512, Di 8, N 4, R 2, chunk
16, so ``blk = chunk * _pick_inner(L / chunk) = 256`` and 2 blocks per row.
The port's twins take the JAX spacing (256) as an argument. All float32.
Tolerances, relative to max(1, max|want|): y and the states 1e-5; the
adjoint's outputs and the six gradients 1e-4 (a 512-step recurrence and
its adjoint summed in another order: JAX chunks by 16 with a log-depth
scan inside each chunk, the twin runs one log-depth scan over L).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.ops import pallas_scan as jps
from lfsr_tpu_torch.ops import scan

B, L, DI, N, R, CHUNK = 2, 512, 8, 4, 2, 16
SPACING = CHUNK * jps._pick_inner(L // CHUNK, max_inner=16)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    rn = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    u, dbc = rn(B, L, DI, sc=0.5), rn(B, L, R + 2 * N, sc=0.5)
    Wdt, bdt = rn(R, DI, sc=0.3), rn(DI, sc=0.1)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (DI, 1)) * np.exp(rn(DI, N, sc=0.1))
    D = 1 + rn(DI, sc=0.1)
    dy = rn(B, L, DI)
    return u, dbc, Wdt, bdt, A, D, dy


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def jax_states():
    u, dbc, Wdt, bdt, A, D, dy = _inputs()
    y, hb = jps._scan_proj_raw_states(*map(jnp.asarray, (u, dbc, Wdt, bdt, A)),
                                      chunk=CHUNK, interpret=True)
    return np.array(y), np.array(hb)


def test_geometry_has_several_blocks():
    assert SPACING == 256 and L // SPACING == 2


def test_k2_twin_matches_pallas_states_kernel(jax_states):
    u, dbc, Wdt, bdt, A, D, _ = _inputs()
    y_j, hb_j = jax_states  # y without the D skip; hb [B, n_blocks, N, Di]
    y, states = scan.selective_scan_proj_states_plain(
        *map(torch.from_numpy, (u, dbc, Wdt, bdt, A)), torch.zeros(DI), spacing=SPACING)
    assert states.dtype == torch.float32 and states.shape == (B, L // SPACING, N, DI)
    _close(states.numpy(), hb_j, 1e-5)
    _close(y.numpy(), y_j, 1e-5)


def test_k2_y_equals_k1_twin_y():
    args = [torch.from_numpy(a) for a in _inputs()[:6]]
    y, _ = scan.selective_scan_proj_states(*args, spacing=SPACING)
    assert torch.equal(y, scan.selective_scan_proj_plain(*args))


def test_k3_twin_matches_pallas_adjoint_kernel(jax_states):
    u, dbc, Wdt, bdt, A, D, dy = _inputs()
    _, hb_j = jax_states
    want = jps._scan_proj_bwd_raw(*map(jnp.asarray, (u, dbc, dy, Wdt, bdt, A)),
                                  jnp.asarray(hb_j), chunk=CHUNK, interpret=True)
    got = scan.selective_scan_proj_bwd(*map(torch.from_numpy, (u, dbc, dy, Wdt, bdt, A, hb_j)),
                                       spacing=SPACING)
    names = ("du_scan", "ddt", "dB", "dC", "dA_part")
    shapes = ((B, L, DI), (B, L, DI), (B, L, N), (B, L, N), (B, N, DI))
    for name, shape, g, w in zip(names, shapes, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape, name
        _close(g.numpy(), w, 1e-4)


def test_scan_function_gradients_match_jax_grad():
    u, dbc, Wdt, bdt, A, D, dy = _inputs(1)
    f = lambda *a: jnp.sum(jps.selective_scan_proj(*a, CHUNK) * jnp.asarray(dy))
    want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, (u, dbc, Wdt, bdt, A, D)))
    args = [torch.from_numpy(a).requires_grad_() for a in (u, dbc, Wdt, bdt, A, D)]
    y = scan.selective_scan_proj(*args)  # the autograd Function: K2 + K3 twins on the CPU
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "ScanProjBackward"
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4)


def test_scan_without_grad_is_k1():
    args = [torch.from_numpy(a).requires_grad_() for a in _inputs()[:6]]
    with torch.no_grad():
        y = scan.selective_scan_proj(*args)
    assert y.grad_fn is None
    np.testing.assert_array_equal(y.numpy(), scan.selective_scan_proj_plain(*args).detach().numpy())

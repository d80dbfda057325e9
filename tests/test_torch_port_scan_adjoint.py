"""K3's chunk-parallel reverse scan (csrc/scan_adjoint.cu), pass by pass in
numpy, against JAX's Pallas adjoint.

The kernel runs only on the card; here its three passes are written out in
numpy (float32, vectorised over batch, states and channels, one step at a
time in t), with the reversed-index bookkeeping the kernel uses:

- A, summaries: every chunk k >= 1 walked back from a zero carry; its
  outgoing carry m_loc and its sum of delta S stored at r = nc - 1 - k;
- B, the carry, as ``chunk_carry_kernel`` computes it over r:
  c = 2^(A log2(e) S[r]) c + m_loc[r], written at r;
- C, the adjoint: chunk k's states recomputed from K2's saved start state
  (the port's K2 twin at spacing 64), the adjoint walked back from the
  carry that pass B left at r = nc - 2 - k (0 for the last chunk); the
  chunks' dA summed in chunk order.

Held against ``_scan_proj_bwd_raw`` in interpret mode fed JAX's own states
(``_scan_proj_raw_states``) at B 2, Di 8, N 4, R 2: L 512 (8 chunks of
64), L 496 (a ragged last chunk of 48) and L 48 (one chunk: pass C alone).
All five outputs within 1e-5 x max(1, max|JAX|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.ops import pallas_scan as jps
from lfsr_tpu_torch.ops import scan

from _torch_port import one_torch_thread  # noqa: F401

B, DI, N, R = 2, 8, 4, 2
TC = scan.STATE_SPACING
JAX_CHUNK = 16
LOG2E = np.float32(1.4426950408889634)
f32 = np.float32


def _inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    rn = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(f32)
    u, dbc = rn(B, L, DI, sc=0.5), rn(B, L, R + 2 * N, sc=0.5)
    Wdt, bdt = rn(R, DI, sc=0.3), rn(DI, sc=0.1)
    A = -np.tile(np.arange(1, N + 1, dtype=f32), (DI, 1)) * np.exp(rn(DI, N, sc=0.1))
    dy = rn(B, L, DI)
    return u, dbc, dy, Wdt, bdt, A


def _delta(dbc, Wdt, bdt):
    raw = dbc[..., :R] @ Wdt + bdt
    return (np.maximum(raw, 0) + np.log1p(np.exp(-np.abs(raw)))).astype(f32)


def _chunks(L):
    return [(k * TC, min(L, (k + 1) * TC)) for k in range(-(-L // TC))]


def summaries(dbc, dy, Wdt, bdt, A):
    """Pass A: (m_loc [B, nc-1, N, Di], S [B, nc-1, Di]), chunk k at
    r = nc - 1 - k, for chunks 1 .. nc-1."""
    L = dy.shape[1]
    delta, Cc, At = _delta(dbc, Wdt, bdt), dbc[..., R + N :], A.T
    nc = len(_chunks(L))
    mloc = np.zeros((B, nc - 1, N, DI), f32)
    dsum = np.zeros((B, nc - 1, DI), f32)
    for k, (t0, t1) in enumerate(_chunks(L)):
        if k == 0:
            continue
        mu, s = np.zeros((B, N, DI), f32), np.zeros((B, DI), f32)
        for t in reversed(range(t0, t1)):
            lam = Cc[:, t, :, None] * dy[:, t, None, :] + mu
            mu = np.exp(delta[:, t, None, :] * At) * lam
            s = s + delta[:, t]
        mloc[:, nc - 1 - k], dsum[:, nc - 1 - k] = mu, s
    return mloc, dsum


def carry(A, mloc, dsum):
    """Pass B, as ``chunk_carry_kernel``: over r in order,
    c = 2^(A log2(e) S[r]) c + m_loc[r], written at r."""
    out, c = np.empty_like(mloc), np.zeros_like(mloc[:, 0])
    a2 = A.T * LOG2E
    for r in range(mloc.shape[1]):
        c = np.exp2(a2 * dsum[:, r, None, :]) * c + mloc[:, r]
        out[:, r] = c
    return out


def adjoint(u, dbc, dy, Wdt, bdt, A, states, carries):
    """Pass C and the sum of dA: (du, ddt, dB, dC, dA [B, N, Di])."""
    L = u.shape[1]
    delta, Bc, Cc, At = _delta(dbc, Wdt, bdt), dbc[..., R : R + N], dbc[..., R + N :], A.T
    chunks = _chunks(L)
    nc = len(chunks)
    du, ddt = np.zeros((B, L, DI), f32), np.zeros((B, L, DI), f32)
    dB, dC = np.zeros((B, L, N), f32), np.zeros((B, L, N), f32)
    dA_chunks = np.zeros((B, nc, N, DI), f32)
    for k, (t0, t1) in enumerate(chunks):
        h0 = states[:, k]
        hs, h = [], h0
        for t in range(t0, t1):
            h = np.exp(delta[:, t, None, :] * At) * h + Bc[:, t, :, None] * (delta[:, t] * u[:, t])[:, None]
            hs.append(h)
        mu = carries[:, nc - 2 - k] if k + 1 < nc else np.zeros((B, N, DI), f32)
        for t in reversed(range(t0, t1)):
            i = t - t0
            dA = np.exp(delta[:, t, None, :] * At)
            lam = Cc[:, t, :, None] * dy[:, t, None, :] + mu
            w = lam * dA * (hs[i - 1] if i else h0)
            dA_chunks[:, k] += w * delta[:, t, None, :]
            s1 = (lam * Bc[:, t, :, None]).sum(1)
            du[:, t] = s1 * delta[:, t]
            ddt[:, t] = s1 * u[:, t] + (w * At).sum(1)
            dB[:, t] = (lam * (delta[:, t] * u[:, t])[:, None]).sum(2)
            dC[:, t] = (hs[i] * dy[:, t, None, :]).sum(2)
            mu = dA * lam
    dA = dA_chunks[:, 0].copy()
    for k in range(1, nc):
        dA += dA_chunks[:, k]
    return du, ddt, dB, dC, dA


def k3_by_passes(u, dbc, dy, Wdt, bdt, A, states):
    carries = carry(A, *summaries(dbc, dy, Wdt, bdt, A)) if u.shape[1] > TC else None
    return adjoint(u, dbc, dy, Wdt, bdt, A, states, carries)


def _port_states(u, dbc, Wdt, bdt, A):
    """K2's saved states at spacing 64, from the port's twin."""
    _, states = scan.selective_scan_proj_states_plain(
        *map(torch.from_numpy, (u, dbc, Wdt, bdt, A)), torch.zeros(DI), spacing=TC)
    return states.numpy()


@pytest.mark.parametrize("L", [512, 496, 48])
def test_passes_match_pallas_adjoint(L):
    u, dbc, dy, Wdt, bdt, A = _inputs(L)
    _, hb = jps._scan_proj_raw_states(*map(jnp.asarray, (u, dbc, Wdt, bdt, A)),
                                      chunk=JAX_CHUNK, interpret=True)
    want = jps._scan_proj_bwd_raw(*map(jnp.asarray, (u, dbc, dy, Wdt, bdt, A)), hb,
                                  chunk=JAX_CHUNK, interpret=True)
    states = _port_states(u, dbc, Wdt, bdt, A)
    assert states.shape == (B, -(-L // TC), N, DI)
    got = k3_by_passes(u, dbc, dy, Wdt, bdt, A, states)
    names = ("du_scan", "ddt", "dB", "dC", "dA_part")
    shapes = ((B, L, DI), (B, L, DI), (B, L, N), (B, L, N), (B, N, DI))
    for name, shape, g, w in zip(names, shapes, got, want):
        w = np.asarray(w, np.float64)
        assert g.dtype == f32 and g.shape == shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= 1e-5 * max(1.0, np.abs(w).max()), (name, err)


def test_carry_at_r_is_the_carry_into_chunk_nc_minus_2_minus_r():
    """One walk back over all of L from a zero carry, read at each chunk
    boundary: the carry entering chunk k (from chunk k + 1) is what pass B
    leaves at r = nc - 2 - k."""
    L = 496
    u, dbc, dy, Wdt, bdt, A = _inputs(L, seed=1)
    delta, Cc, At = _delta(dbc, Wdt, bdt), dbc[..., R + N :], A.T
    chunks = _chunks(L)
    nc = len(chunks)
    mu, mu_in = np.zeros((B, N, DI), f32), {}
    for k in reversed(range(nc)):
        mu_in[k] = mu
        for t in reversed(range(*chunks[k])):
            mu = np.exp(delta[:, t, None, :] * At) * (Cc[:, t, :, None] * dy[:, t, None, :] + mu)
    carries = carry(A, *summaries(dbc, dy, Wdt, bdt, A))
    assert carries.shape == (B, nc - 1, N, DI)
    for r in range(nc - 1):
        want = mu_in[nc - 2 - r]
        err = np.abs(carries[:, r] - want).max()
        assert err <= 1e-5 * max(1.0, np.abs(want).max()), (r, err)

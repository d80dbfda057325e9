"""The scan kernels at d_state 24 (``EfficientLFNetV7``'s default), on the CPU.

The kernels run only on the card (tests/test_torch_port_cuda.py holds them
against their twins there). Here:

- the lane plans: K1/K2's chunk-parallel scan and K3's summaries put
  ``scan_lanes(24)`` = 2 lanes of 12 states on a channel (a power of two,
  so a channel's lanes are one shuffle butterfly, and 12 states keep B and C
  read 4 at a time); the one-warp layouts (K3's adjoint pass, K9a-K9c) span
  ``state_span(24)`` = 32 lanes, the 8 past the states holding zeros. Both
  are one function each in csrc/common.cuh, mirrored here; every scan
  source instantiates every d_state of ``scan.D_STATES``;
- the wrappers take N 24 to their kernels and refuse an N outside the set
  with a message that names it;
- numpy models of both layouts, float32 and one step at a time as the
  kernels walk: K1's three passes (chunk summaries, the carry, chunk
  outputs) with each lane summing C h over its own states and the lanes'
  sums added by the butterfly, and the one-warp scan with its 32-lane
  butterfly over 24 live lanes, held against JAX's Pallas scans
  (``selective_scan_proj``, ``selective_scan_fused``) in interpret mode at
  N 24, V7's dt rank 5 (B 2, L 256, Di 10): within 1e-5 of max(1, max|y|).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.ops import pallas_scan as jps
from lfsr_tpu_torch.ops import _cuda, scan

from _torch_port import one_torch_thread  # noqa: F401

CSRC = Path(scan.__file__).resolve().parents[1] / "csrc"
f32 = np.float32
LOG2E = f32(1.4426950408889634)
B, L, DI, N, R = 2, 256, 10, 24, 5


def scan_lanes(n: int) -> int:
    """``lfsr::scan_lanes`` (csrc/common.cuh): lanes a channel in K1/K2's
    chunk-parallel scan and K3's summaries, each holding n / P states."""
    return 1 if n <= 8 else 2 if n <= 24 else n // 8


def state_span(n: int) -> int:
    """``lfsr::state_span``: lanes a channel spans in the one-warp layouts."""
    return next(p for p in (4, 8, 16, 32) if n <= p)


def test_lane_plans_at_24():
    assert scan_lanes(24) == 2 and state_span(24) == 32
    for n in scan.D_STATES:
        p, span = scan_lanes(n), state_span(n)
        assert p & (p - 1) == 0 and n % p == 0 and 32 % p == 0  # one butterfly of P lanes
        assert (n // p) % 4 == 0 or n // p < 4  # B and C read 4 states at a time
        assert span & (span - 1) == 0 and n <= span <= 32 and (span == n) == (n != 24)


def test_one_lane_plan_for_every_scan_source():
    """``lfsr::scan_lanes`` and ``lfsr::state_span`` are defined once, in
    common.cuh, with the rule this file mirrors, and used by the scans;
    each source's d_state switch has a case for each of D_STATES."""
    common = (CSRC / "common.cuh").read_text()
    assert "constexpr int scan_lanes(int N) { return N <= 8 ? 1 : N <= 24 ? 2 : N / 8; }" in common
    assert "return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32;" in common
    for name, uses in (("scan_chunked.cu", ("scan_lanes",)),
                       ("scan_adjoint.cu", ("scan_lanes", "state_span")),
                       ("scan.cu", ("state_span",))):
        src = (CSRC / name).read_text()
        assert "lanes_for" not in src and "constexpr int scan_lanes" not in src
        assert all(f"lfsr::{u}(N)" in src for u in uses), name
        cases = {int(c) for c in re.findall(r"case (\d+): return", src)}
        assert cases == set(scan.D_STATES), (name, cases)


@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "row_stride", lambda t, *a, **k: t.stride(1))
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


def _torch_operands(n, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    A = -torch.arange(1, n + 1, dtype=torch.float32).repeat(DI, 1)
    return (torch.randn(B, 300, DI, generator=g).to(dtype),
            torch.randn(B, 300, R + 2 * n, generator=g).to(dtype), torch.randn(R, DI, generator=g),
            torch.randn(DI, generator=g), A, torch.ones(DI))


@pytest.mark.parametrize("n,ok", [(24, True), (16, True), (12, False), (20, False), (64, False)])
def test_wrappers_take_24_and_name_the_set_otherwise(launches, n, ok):
    u, dbc, Wdt, bdt, A, D = _torch_operands(n)
    Bc, Cc = dbc[..., R : R + n], dbc[..., R + n :]
    calls = [lambda: scan.selective_scan_proj(u, dbc, Wdt, bdt, A, D),
             lambda: scan.selective_scan_fused(u, u, A, Bc, Cc, D),
             lambda: scan.scan_gated_fused(u, u, A, Bc, Cc, u, D, torch.randn(DI, 4))]
    with torch.no_grad():
        for call in calls:
            if ok:
                call()
            else:
                with pytest.raises(ValueError, match=re.escape(str(scan.D_STATES))):
                    call()
    if ok:
        names = [name for name, _ in launches]
        assert {"lfsr_chunk_scan_outputs", "lfsr_scan_given", "lfsr_scan_gate"} <= set(names)
        calls = dict(launches)  # N as each kernel is given it
        assert calls["lfsr_chunk_scan_outputs"][-5] == calls["lfsr_scan_given"][-4] == n
        assert calls["lfsr_scan_gate"][-5] == n
    else:
        assert not launches


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    rn = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(f32)
    u, dbc = rn(B, L, DI, sc=0.5), rn(B, L, R + 2 * N, sc=0.5)
    Wdt, bdt = rn(R, DI, sc=0.3), rn(DI, sc=0.1)
    A = -np.tile(np.arange(1, N + 1, dtype=f32), (DI, 1)) * np.exp(rn(DI, N, sc=0.1))
    return u, dbc, Wdt, bdt, A, 1 + rn(DI, sc=0.1)


def _delta(dbc, Wdt, bdt):
    raw = (dbc[..., :R] @ Wdt + bdt).astype(f32)
    return (np.maximum(raw, 0) + np.log1p(np.exp(-np.abs(raw)))).astype(f32)


def k1_lane_model(u, dbc, Wdt, bdt, A, D, tc, lanes):
    """K1's passes with ``lanes`` lanes a channel: returns y [B, L, Di]."""
    delta = _delta(dbc, Wdt, bdt)
    Bm, Cm = dbc[..., R : R + N], dbc[..., R + N :]
    a2 = (A * LOG2E).T.astype(f32)  # [N, Di]
    nc = -(-L // tc)
    ns = N // lanes
    hloc = np.zeros((B, nc, N, DI), f32)
    dsum = np.zeros((B, nc, DI), f32)
    for c in range(nc - 1):  # pass 1: each chunk from h = 0
        h = np.zeros((B, N, DI), f32)
        for t in range(c * tc, (c + 1) * tc):
            dA = np.exp2(delta[:, t, None] * a2).astype(f32)
            h = (dA * h + Bm[:, t, :, None] * (delta[:, t] * u[:, t])[:, None]).astype(f32)
            dsum[:, c] += delta[:, t]
        hloc[:, c] = h
    start = np.zeros((B, nc, N, DI), f32)
    for c in range(nc - 1):  # pass 2: the carry
        start[:, c + 1] = np.exp2(a2 * dsum[:, c, None]) * start[:, c] + hloc[:, c]
    y = np.zeros((B, L, DI), f32)
    for c in range(nc):  # pass 3: each chunk from its start state
        h = start[:, c].copy()
        for t in range(c * tc, min(L, (c + 1) * tc)):
            dA = np.exp2(delta[:, t, None] * a2).astype(f32)
            h = (dA * h + Bm[:, t, :, None] * (delta[:, t] * u[:, t])[:, None]).astype(f32)
            part = np.zeros((lanes, B, DI), f32)
            for lane in range(lanes):  # each lane's C h over its own states, in order
                for i in range(lane * ns, (lane + 1) * ns):
                    part[lane] = (part[lane] + Cm[:, t, i, None] * h[:, i]).astype(f32)
            o = 1
            while o < lanes:  # the butterfly over the channel's lanes
                part = (part + part[np.arange(lanes) ^ o]).astype(f32)
                o *= 2
            y[:, t] = u[:, t] * D + part[0]
    return y


def one_warp_model(u, delta, A, Bm, Cm, D):
    """The one-warp scan (csrc/scan.cu) at N 24: 32 lanes a channel, lanes
    24-31 holding h = 0 and adding 0; the sum over n a 32-lane butterfly."""
    span = state_span(N)
    a = np.zeros((DI, span), f32)
    a[:, :N] = A
    h = np.zeros((B, DI, span), f32)
    y = np.zeros((B, L, DI), f32)
    for t in range(L):
        bx = np.zeros((B, DI, span), f32)
        cv = np.zeros((B, span), f32)
        bx[..., :N] = Bm[:, t, None, :] * (delta[:, t] * u[:, t])[..., None]
        cv[:, :N] = Cm[:, t]
        h = (np.exp(delta[:, t, :, None] * a) * h + bx).astype(f32)
        part = (cv[:, None, :] * h).astype(f32)
        o = span // 2
        while o:
            part = (part + part[..., np.arange(span) ^ o]).astype(f32)
            o //= 2
        y[:, t] = part[..., 0] + u[:, t] * D
    return y


@pytest.mark.parametrize("lanes", [scan_lanes(24), 4])
@pytest.mark.parametrize("tc", [64, 128])
def test_k1_lane_split_at_24_matches_jax_pallas_scan(lanes, tc):
    """The chosen split (2 lanes of 12 states) and the one measured beside
    it (4 of 6), chunks of 64 and 128 steps."""
    u, dbc, Wdt, bdt, A, D = _inputs()
    want = np.asarray(jps.selective_scan_proj(*map(jnp.asarray, (u, dbc, Wdt, bdt, A, D)),
                                              chunk=64))
    got = k1_lane_model(u, dbc, Wdt, bdt, A, D, tc, lanes)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_one_warp_padded_lanes_at_24_match_jax_pallas_scan():
    u, dbc, Wdt, bdt, A, D = _inputs(1)
    delta = _delta(dbc, Wdt, bdt)
    Bm, Cm = dbc[..., R : R + N], dbc[..., R + N :]
    want = np.asarray(jps.selective_scan_fused(*map(jnp.asarray, (u, delta, A, Bm, Cm, D)),
                                               chunk=64))
    got = one_warp_model(u, delta, A, Bm, Cm, D)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale

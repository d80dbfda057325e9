"""K1 / K2 / K3 — the Mamba selective scan with the dt projection folded in;
K9b / K9c — the scan with the Mamba epilogue, and the whole inner pipeline;
K9a — the op-level scan with delta, B and C given.

Port of lfsr_tpu/ops/pallas_scan.py::selective_scan_proj and its custom_vjp
(Pallas kernels ``_scan_proj_kernel`` K1, ``_scan_proj_states_kernel`` K2,
``_scan_proj_bwd_kernel`` K3). From the raw x_proj output
``dbc = [dt_low_rank | B | C]`` it computes

    delta = softplus(dbc[..., :R] @ Wdt + bdt)
    y = selective_scan(u, delta, A, dbc[..., R:R+N], dbc[..., R+N:], D_skip)

:func:`selective_scan_proj` is the model's entry. With no gradient wanted
(``torch.no_grad``/``inference_mode``, or no input requiring one) it is K1
alone. Otherwise it is the autograd Function :class:`ScanProj`: forward K2,
which also saves the state at every ``STATE_SPACING``-th step, and backward
K3, the reverse adjoint scan seeded from those states, followed by the
dt-projection chain in PyTorch (``_sp_bwd``, pallas_scan.py:340-377).
K1 and K2 run the chunk-parallel scan of csrc/scan_chunked.cu
(:func:`chunk_scan_passes`: chunk summaries, a carry over the chunks,
chunk outputs) with the chunk length of :func:`scan_chunk_len`; K3 the
chunk-parallel reverse scan of csrc/scan_adjoint.cu
(:func:`adjoint_passes`: the same three passes run backwards over chunks
of ``STATE_SPACING`` steps, then a sum of the chunks' dA).

The flagship's opt-in ``scan_impl``s (lfsr_tpu/models/ssm.py:99-153) have
their own kernels: :func:`scan_gated_fused` (K9b, ``'gated'``:
``_scan_gated_kernel``) and :func:`mamba_inner_fused` (K9c, ``'fused'``:
``_mamba_inner_kernel``). Their gradient is their plain twin's
(``_cuda.PlainVJP``), as the JAX custom_vjps differentiate the references.

:func:`selective_scan_fused` (K9a, ``_scan_chunk_kernel`` and its
flat-lane variant, one function) is an op of the JAX package that no model
calls; its gradient is that of the chunked scan, as JAX's custom_vjp.

The plain twins of K1, K9b and K9c scan as the JAX references do
(:func:`scan_ref`): chunk by chunk (``selective_scan_chunked``, chunk 256,
checkpointed) when ``L % 256 == 0 and L > 4096``, which every L of the
flagship's paths meets (tiled, whole-scene, training), else over the whole
sequence at once.

Each kernel wrapper launches its kernel (csrc/scan_chunked.cu,
csrc/scan_adjoint.cu, csrc/scan.cu, csrc/mamba_inner.cu) on a CUDA tensor
and runs its plain twin on a CPU tensor. The kernels take any L: the TPU's
pad-to-a-multiple-of-128 (ssm.py:109-113) and the ``L % 128 == 0`` gate of
``'fused'`` (ssm.py:144) are Pallas tiling constraints with no counterpart
here (off that gate JAX runs ``mamba_inner_ref``, the same function:
tests/test_pallas_scan.py:153-178).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfsr_tpu_torch.ops import _cuda
from lfsr_tpu_torch.ops.selective_scan import (
    readout, scan_states, selective_scan, selective_scan_chunked,
)

# steps between saved states (K2) == the adjoint's chunk length (K3)
STATE_SPACING = 64
# K1/K2's chunk-parallel scan (csrc/scan_chunked.cu): chunks short enough
# that B x L / Tc reaches SCAN_CTAS, in multiples of STATE_SPACING
SCAN_CTAS = 4096
# the twins scan chunk by chunk at L % SCAN_CHUNK == 0 and L > CHUNKED_ABOVE,
# as the JAX references do (pallas_scan.py:281-283, 472-475, 720-723)
SCAN_CHUNK, CHUNKED_ABOVE = 256, 4096
# where the forward scan takes delta from (ScanParams::mode, csrc/scan.cu)
_FROM_DBC, _GIVEN_RAW, _GIVEN = 0, 1, 2
# d_state values every scan kernel is compiled for (the switches of
# csrc/scan_chunked.cu, scan_adjoint.cu and scan.cu)
D_STATES = (4, 8, 16, 24, 32)


def _check_d_state(N: int, R: int | None = None) -> None:
    if N not in D_STATES:
        raise ValueError(f"scan kernels take d_state in {D_STATES}, got N={N}")
    if R is not None and not 1 <= R <= 8:
        raise ValueError(f"scan kernels take dt_rank in 1..8, got R={R}")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """logaddexp(x, 0): the form jax.nn.softplus (and the kernel) use."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def conv_silu(xs: torch.Tensor, wconv: torch.Tensor, bconv: torch.Tensor, dt) -> torch.Tensor:
    """Causal depthwise conv1d + SiLU over L. xs [B, L, Di]; wconv [K, Di];
    the K taps are accumulated in order in ``dt``, then the bias, as the JAX
    ``Mamba._conv_silu``."""
    K, L = wconv.shape[0], xs.shape[1]
    xp = F.pad(xs.to(dt), (0, 0, K - 1, 0))
    w = wconv.to(dt)
    acc = xp[:, 0:L] * w[0]
    for k in range(1, K):
        acc = acc + xp[:, k : k + L] * w[k]
    return F.silu(bconv.to(dt) + acc)


def scan_ref(u, delta, A, Bc, Cc, D_skip=None):
    """The twins' scan, with JAX's switch: :func:`selective_scan_chunked`
    (chunk 256) when ``L % 256 == 0 and L > 4096``, else the log-depth
    :func:`selective_scan` over the whole sequence."""
    L = u.shape[1]
    if L % SCAN_CHUNK == 0 and L > CHUNKED_ABOVE:
        return selective_scan_chunked(u, delta, A, Bc, Cc, D_skip, SCAN_CHUNK)
    return selective_scan(u, delta, A, Bc, Cc, D_skip)


def _split_dbc(dbc, Wdt, bdt, N):
    """(delta, B, C) in float32 from the raw x_proj output."""
    f32, R = torch.float32, Wdt.shape[0]
    d32 = dbc.to(f32)
    delta = softplus(d32[..., :R] @ Wdt.to(f32) + bdt.to(f32))
    return delta, d32[..., R : R + N], d32[..., R + N :]


def _check_scan(u, dbc, Wdt, bdt, A, D_skip=None):
    """Validate the operands every scan kernel takes; returns the dtype code."""
    B, L, Di = u.shape
    R, N = Wdt.shape[0], A.shape[1]
    dev, f32 = u.device, torch.float32
    code = _cuda.dtype_code(u, "u")
    _cuda.check(u, "u", device=dev)
    _cuda.check(dbc, "dbc", (B, L, R + 2 * N), u.dtype, dev)
    _cuda.check(Wdt, "Wdt", (R, Di), f32, dev)
    _cuda.check(bdt, "bdt", (Di,), f32, dev)
    _cuda.check(A, "A", (Di, N), f32, dev)
    if D_skip is not None:
        _cuda.check(D_skip, "D_skip", (Di,), f32, dev)
    _check_d_state(N, R)
    return code


# --------------------------------------------------------------------------
# K1: the forward
# --------------------------------------------------------------------------

def selective_scan_proj_plain(u, dbc, Wdt, bdt, A, D_skip):
    """Plain twin of K1. u [B, L, Di]; dbc [B, L, R+2N]; Wdt [R, Di];
    bdt [Di]; A [Di, N] (negative); D_skip [Di]. Returns u.dtype."""
    delta, Bc, Cc = _split_dbc(dbc, Wdt, bdt, A.shape[1])
    return scan_ref(u, delta, A, Bc, Cc, D_skip)


def scan_chunk_len(B: int, L: int, spacing: int = STATE_SPACING) -> int:
    """Steps per chunk of K1/K2's chunk-parallel scan at batch B and length
    L: the longest multiple of ``spacing`` (K2's saved states fall on chunk
    starts) with B L / Tc >= :data:`SCAN_CTAS`, at least ``spacing``. K1 and
    K2 both call it, so at the same (B, L) they run the same chunks and K2's
    y is K1's bit for bit."""
    return spacing * max(1, B * L // (SCAN_CTAS * spacing))


def chunk_scan_passes(u, dbc, Wdt, bdt, A, D_skip, y, states=None, spacing=STATE_SPACING):
    """The launches of K1 (``states`` None) or K2 on checked CUDA operands,
    as [(pass name, thunk)] in order: "summaries", "carry" (both only when
    L spans more than one chunk) and "outputs", which writes y (and
    ``states``), with chunks of :func:`scan_chunk_len` steps. The scratch
    (end states and delta sums of every chunk but the last, float32) comes
    from PyTorch's allocator. The thunks count no launch."""
    B, L, Di = u.shape
    R, N = Wdt.shape[0], A.shape[1]
    code = _cuda.DTYPE_CODES[u.dtype]
    tc = scan_chunk_len(B, L, spacing)
    nc = -(-L // tc)
    stream = _cuda.stream_of(u)
    common = (u.data_ptr(), dbc.data_ptr(), Wdt.data_ptr(), bdt.data_ptr(), A.data_ptr())
    hloc = dsum = None
    passes = []
    if nc > 1:
        f32 = dict(dtype=torch.float32, device=u.device)
        hloc = torch.empty((B, nc - 1, N, Di), **f32)
        dsum = torch.empty((B, nc - 1, Di), **f32)
        passes += [
            ("summaries", lambda: _cuda.launch(
                "lfsr_chunk_scan_summaries", *common, hloc.data_ptr(), dsum.data_ptr(), B, L, Di,
                R, N, tc, code, stream)),
            ("carry", lambda: _cuda.launch(
                "lfsr_chunk_scan_carry", A.data_ptr(), hloc.data_ptr(), dsum.data_ptr(), B, Di, N,
                nc - 1, stream)),
        ]
    passes.append(("outputs", lambda: _cuda.launch(
        "lfsr_chunk_scan_outputs", *common, D_skip.data_ptr(),
        None if hloc is None else hloc.data_ptr(), y.data_ptr(),
        None if states is None else states.data_ptr(), B, L, Di, R, N, tc, spacing, code, stream)))
    return passes


def _scan_proj(u, dbc, Wdt, bdt, A, D_skip):
    """K1: kernel on CUDA tensors, plain twin on CPU tensors."""
    if _cuda.use_plain(u):
        return selective_scan_proj_plain(u, dbc, Wdt, bdt, A, D_skip)
    _check_scan(u, dbc, Wdt, bdt, A, D_skip)
    y = torch.empty_like(u)
    for _, launch in chunk_scan_passes(u, dbc, Wdt, bdt, A, D_skip, y):
        launch()
    selective_scan_proj.launches += 1
    return y


# --------------------------------------------------------------------------
# K2: the training forward (y and the saved states)
# --------------------------------------------------------------------------

def selective_scan_proj_states_plain(u, dbc, Wdt, bdt, A, D_skip, spacing=STATE_SPACING):
    """Plain twin of K2: (y, states), y as K1's twin gives it and
    states [B, ceil(L/spacing), N, Di] float32 with states[:, k] the state
    before step k*spacing (zero for k = 0) — JAX's h_bounds layout."""
    delta, Bc, Cc = _split_dbc(dbc, Wdt, bdt, A.shape[1])
    h = scan_states(u, delta, A, Bc)  # [B, L, Di, N]
    y = readout(h, u, Cc, D_skip)
    B, L, Di, N = h.shape
    nb = -(-L // spacing)
    starts = h[:, spacing - 1 :: spacing][:, : nb - 1]
    states = torch.cat([h.new_zeros(B, 1, Di, N), starts], dim=1)
    return y, states.transpose(2, 3).contiguous()


@_cuda.counted
def selective_scan_proj_states(u, dbc, Wdt, bdt, A, D_skip, spacing=STATE_SPACING):
    """K2: kernel on CUDA tensors, plain twin on CPU tensors. Returns
    (y, states) as :func:`selective_scan_proj_states_plain`; y is K1's."""
    if _cuda.use_plain(u):
        return selective_scan_proj_states_plain(u, dbc, Wdt, bdt, A, D_skip, spacing)
    _check_scan(u, dbc, Wdt, bdt, A, D_skip)
    B, L, Di = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    states = torch.empty((B, -(-L // spacing), N, Di), dtype=torch.float32, device=u.device)
    for _, launch in chunk_scan_passes(u, dbc, Wdt, bdt, A, D_skip, y, states, spacing):
        launch()
    selective_scan_proj_states.launches += 1
    return y, states


# --------------------------------------------------------------------------
# K3: the adjoint
# --------------------------------------------------------------------------

def selective_scan_proj_bwd_plain(u, dbc, dy, Wdt, bdt, A, states, spacing=STATE_SPACING):
    """Plain twin of K3: autograd through :func:`selective_scan` with delta
    precomputed, one batch row at a time (each row's log-depth scan holds
    several [L, Di, N] float32 tensors). It recomputes the states, so
    ``states`` and ``spacing`` are not read. Returns (du_scan, ddt, dB, dC,
    dA_part) float32: [B, L, Di] x2, [B, L, N] x2, [B, N, Di]."""
    f32, N = torch.float32, A.shape[1]
    rows = []
    for i in range(u.shape[0]):
        delta, Bc, Cc = _split_dbc(dbc[i : i + 1], Wdt.detach(), bdt.detach(), N)
        leaves = [t.detach().to(f32).requires_grad_()
                  for t in (u[i : i + 1], delta, Bc, Cc, A)]
        with torch.enable_grad():
            y = selective_scan(*leaves[:2], leaves[4], *leaves[2:4])
            # at L = 1, y does not depend on A: its gradient is zero
            du, ddt, dB, dC, dA = torch.autograd.grad(
                y, leaves, dy[i : i + 1].to(f32), allow_unused=True, materialize_grads=True)
        rows.append((du, ddt, dB, dC, dA.t()[None]))
    return tuple(torch.cat(parts) for parts in zip(*rows))


def adjoint_passes(u, dbc, dy, Wdt, bdt, A, states, outs, spacing=STATE_SPACING):
    """The launches of K3 (csrc/scan_adjoint.cu) on checked CUDA operands,
    as [(pass name, thunk)] in order, with chunks of ``spacing`` steps (the
    spacing of K2's states): "adjoint summaries" (each chunk's walk back
    from a zero carry, at reversed chunk indices) and "carry" (K1's carry,
    csrc/scan_chunked.cu, over those summaries), both only when L spans
    more than one chunk; "adjoint", which writes du, ddt, dB and dC of
    ``outs`` = (du, ddt, dB, dC, dA) and each chunk's dA; and "sum dA",
    which sums those in chunk order (with one chunk the adjoint writes dA
    itself). The scratch (float32: the summaries [B, nc-1, N, Di] and
    [B, nc-1, Di], the chunks' dA [B, nc, N, Di]) comes from PyTorch's
    allocator. The thunks count no launch."""
    B, L, Di = u.shape
    R, N = Wdt.shape[0], A.shape[1]
    code = _cuda.DTYPE_CODES[u.dtype]
    nc = -(-L // spacing)
    stream = _cuda.stream_of(u)
    du, ddt, dB, dC, dA = outs
    weights = (Wdt.data_ptr(), bdt.data_ptr(), A.data_ptr())
    mloc = None
    dA_chunks = dA
    passes = []
    if nc > 1:
        f32 = dict(dtype=torch.float32, device=u.device)
        mloc = torch.empty((B, nc - 1, N, Di), **f32)
        dsum = torch.empty((B, nc - 1, Di), **f32)
        dA_chunks = torch.empty((B, nc, N, Di), **f32)
        passes += [
            ("adjoint summaries", lambda: _cuda.launch(
                "lfsr_scan_adjoint_summaries", dbc.data_ptr(), dy.data_ptr(), *weights,
                mloc.data_ptr(), dsum.data_ptr(), B, L, Di, R, N, spacing, code, stream)),
            ("carry", lambda: _cuda.launch(
                "lfsr_chunk_scan_carry", A.data_ptr(), mloc.data_ptr(), dsum.data_ptr(), B, Di,
                N, nc - 1, stream)),
        ]
    passes.append(("adjoint", lambda: _cuda.launch(
        "lfsr_scan_adjoint", u.data_ptr(), dbc.data_ptr(), dy.data_ptr(), *weights,
        states.data_ptr(), None if mloc is None else mloc.data_ptr(), du.data_ptr(),
        ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA_chunks.data_ptr(), B, L, Di, R, N,
        spacing, code, stream)))
    if nc > 1:
        passes.append(("sum dA", lambda: _cuda.launch(
            "lfsr_sum_parts", dA_chunks.data_ptr(), dA.data_ptr(), B, nc, N * Di, stream)))
    return passes


@_cuda.counted
def selective_scan_proj_bwd(u, dbc, dy, Wdt, bdt, A, states, spacing=STATE_SPACING):
    """K3: kernel on CUDA tensors, plain twin on CPU tensors. u, dbc, dy in
    the compute dtype; states from K2 at the same ``spacing``."""
    if _cuda.use_plain(u):
        return selective_scan_proj_bwd_plain(u, dbc, dy, Wdt, bdt, A, states, spacing)
    _check_scan(u, dbc, Wdt, bdt, A)
    B, L, Di = u.shape
    N = A.shape[1]
    if spacing != STATE_SPACING:
        raise ValueError(f"the adjoint kernel takes states every {STATE_SPACING} steps, "
                         f"got {spacing}")
    _cuda.check(dy, "dy", (B, L, Di), u.dtype, u.device)
    _cuda.check(states, "states", (B, -(-L // spacing), N, Di), torch.float32, u.device)
    f32 = dict(dtype=torch.float32, device=u.device)
    outs = (torch.empty((B, L, Di), **f32), torch.empty((B, L, Di), **f32),
            torch.empty((B, L, N), **f32), torch.empty((B, L, N), **f32),
            torch.empty((B, N, Di), **f32))
    for _, launch in adjoint_passes(u, dbc, dy, Wdt, bdt, A, states, outs, spacing):
        launch()
    selective_scan_proj_bwd.launches += 1
    return outs


# --------------------------------------------------------------------------
# the differentiable scan
# --------------------------------------------------------------------------

class ScanProj(torch.autograd.Function):
    """selective_scan_proj with the custom_vjp of pallas_scan.py:286-380:
    forward K2 (saving the states), backward K3 + the dt-projection chain."""

    @staticmethod
    def forward(ctx, u, dbc, Wdt, bdt, A, D_skip):
        y, states = selective_scan_proj_states(u, dbc, Wdt, bdt, A, D_skip)
        ctx.save_for_backward(u, dbc, Wdt, bdt, A, D_skip, states)
        return y

    @staticmethod
    def backward(ctx, g):
        u, dbc, Wdt, bdt, A, D_skip, states = ctx.saved_tensors
        f32, R = torch.float32, Wdt.shape[0]
        g = g.to(u.dtype).contiguous()
        du_s, ddt, dB, dC, dA_part = selective_scan_proj_bwd(u, dbc, g, Wdt, bdt, A, states)
        # the dt low-rank projection chain, in PyTorch as JAX leaves it to XLA
        lanes = dbc[..., :R].to(f32)
        ddtraw = ddt * torch.sigmoid(lanes @ Wdt.to(f32) + bdt.to(f32))  # d softplus
        ddbc = torch.cat([ddtraw @ Wdt.to(f32).t(), dB, dC], dim=-1).to(dbc.dtype)
        dWdt = (lanes.reshape(-1, R).t() @ ddtraw.reshape(-1, ddtraw.shape[-1])).to(Wdt.dtype)
        dbdt = ddtraw.sum(dim=(0, 1)).to(bdt.dtype)
        dA = dA_part.sum(dim=0).t().to(A.dtype)  # [B, N, Di] -> [Di, N]
        gy = g.to(f32)
        du = (du_s + gy * D_skip.to(f32)).to(u.dtype)
        dD = (gy * u.to(f32)).sum(dim=(0, 1)).to(D_skip.dtype)
        return du, ddbc, dWdt, dbdt, dA, dD


@_cuda.counted
def selective_scan_proj(u, dbc, Wdt, bdt, A, D_skip):
    """The model's scan: K1 when no gradient is wanted, else :class:`ScanProj`
    (K2 forward, K3 backward). ``launches`` counts K1's launches."""
    if _cuda.wants_grad(u, dbc, Wdt, bdt, A, D_skip):
        return ScanProj.apply(u, dbc, Wdt, bdt, A, D_skip)
    return _scan_proj(u, dbc, Wdt, bdt, A, D_skip)


# --------------------------------------------------------------------------
# K9b: the scan with the Mamba epilogue (scan_impl='gated')
# --------------------------------------------------------------------------

def scan_gated_plain(u, delta, A, Bc, Cc, z, D_skip, Wout, pre_softplus=False):
    """Plain twin of K9b (port of pallas_scan.py::scan_gated_ref):
    ((scan(u, delta, A, Bc, Cc) + u D_skip) * silu(z)) @ Wout. u, delta, z
    [B, L, Di]; Bc, Cc [B, L, N]; Wout [Di, Dout]; with ``pre_softplus``
    delta is softplus'd first. The gated y is rounded to Wout.dtype before
    the product; returns u.dtype."""
    f32 = torch.float32
    d = softplus(delta.to(f32)) if pre_softplus else delta.to(f32)
    y = scan_ref(u, d, A, Bc, Cc, D_skip).to(f32) * F.silu(z.to(f32))
    return (y.to(Wout.dtype) @ Wout).to(u.dtype)


def _scan_gated(u, delta, A, Bc, Cc, z, D_skip, Wout, pre_softplus):
    """K9b: kernel on CUDA tensors, plain twin on CPU tensors. The kernel
    takes every operand but A and D_skip in one dtype (the model's compute
    dtype; the twin takes any mix); Bc, Cc and z may be slices of a wider
    last axis (of dbc, of in_proj's output)."""
    if _cuda.use_plain(u):
        return scan_gated_plain(u, delta, A, Bc, Cc, z, D_skip, Wout, pre_softplus)
    B, L, Di = u.shape
    N, Dout = A.shape[1], Wout.shape[1]
    dev, f32 = u.device, torch.float32
    code = _cuda.dtype_code(u, "u")
    _cuda.check(u, "u", (B, L, Di), u.dtype, dev)
    _cuda.check(delta, "delta", (B, L, Di), u.dtype, dev)
    sb = _cuda.row_stride(Bc, "Bc", (B, L, N), u.dtype, dev)
    sc = _cuda.row_stride(Cc, "Cc", (B, L, N), u.dtype, dev)
    sz = _cuda.row_stride(z, "z", (B, L, Di), u.dtype, dev)
    _cuda.check(A, "A", (Di, N), f32, dev)
    _cuda.check(D_skip, "D_skip", (Di,), f32, dev)
    _cuda.check(Wout, "Wout", (Di, Dout), u.dtype, dev)
    _check_d_state(N)
    stream = _cuda.stream_of(u)
    gated = torch.empty_like(u)
    _cuda.launch(
        "lfsr_scan_gate", u.data_ptr(), None, delta.data_ptr(), Bc.data_ptr(), sb,
        Cc.data_ptr(), sc, z.data_ptr(), sz, gated.data_ptr(), None, None, A.data_ptr(),
        D_skip.data_ptr(), B, L, Di, 0, N, _GIVEN_RAW if pre_softplus else _GIVEN, code, code,
        stream,
    )
    out = torch.empty((B, L, Dout), dtype=u.dtype, device=dev)
    _cuda.launch("lfsr_rows_matmul", gated.data_ptr(), Wout.data_ptr(), out.data_ptr(), B * L,
                 Di, Dout, code, stream)
    scan_gated_fused.launches += 1
    return out


@_cuda.counted
def scan_gated_fused(u, delta, A, Bc, Cc, z, D_skip, Wout, pre_softplus=False):
    """K9b, the model's entry under ``scan_impl='gated'``: the kernel (its
    twin on the CPU); with a gradient wanted, through ``_cuda.PlainVJP`` (the
    twin's gradient, as ``_sg_bwd`` differentiates ``scan_gated_ref``)."""
    args = (u, delta, A, Bc, Cc, z, D_skip, Wout, pre_softplus)
    if _cuda.wants_grad(*args[:-1]):
        return _cuda.PlainVJP.apply(_scan_gated, scan_gated_plain, *args)
    return _scan_gated(*args)


# --------------------------------------------------------------------------
# K9c: the fused Mamba inner pipeline (scan_impl='fused')
# --------------------------------------------------------------------------

def mamba_inner_plain(xs, z, wconv, bconv, Wx, Wdt, bdt, A, D_skip):
    """Plain twin of K9c (port of pallas_scan.py::mamba_inner_ref), float32
    throughout: xc = silu(causal depthwise conv1d(xs) + bconv); dbc = xc @ Wx;
    delta = softplus(dbc[..., :R] @ Wdt + bdt); y = (scan(xc, delta, A, B, C)
    + xc D_skip) * silu(z). xs, z [B, L, Di]; wconv [K, Di]; Wx [Di, R+2N];
    Wdt [R, Di]; A [Di, N] (negative). Returns xs.dtype."""
    f32 = torch.float32
    xc = conv_silu(xs, wconv, bconv, f32)
    delta, Bc, Cc = _split_dbc(xc @ Wx.to(f32), Wdt, bdt, A.shape[1])
    y = scan_ref(xc, delta, A, Bc, Cc, D_skip)
    return (y * F.silu(z.to(f32))).to(xs.dtype)


def _mamba_inner(xs, z, wconv, bconv, Wx, Wdt, bdt, A, D_skip):
    """K9c: kernel on CUDA tensors, plain twin on CPU tensors. The front
    (conv + SiLU + x_proj, float32 xc and dbc) and then the scan from dbc
    with the gate; xs and z may be the halves of in_proj's output."""
    if _cuda.use_plain(xs):
        return mamba_inner_plain(xs, z, wconv, bconv, Wx, Wdt, bdt, A, D_skip)
    B, L, Di = xs.shape
    KC, R, N = wconv.shape[0], Wdt.shape[0], A.shape[1]
    J = R + 2 * N
    dev, f32 = xs.device, torch.float32
    code = _cuda.dtype_code(xs, "xs")
    sx = _cuda.row_stride(xs, "xs", (B, L, Di), xs.dtype, dev)
    sz = _cuda.row_stride(z, "z", (B, L, Di), xs.dtype, dev)
    for t, name, shape in ((wconv, "wconv", (KC, Di)), (bconv, "bconv", (Di,)),
                           (Wx, "Wx", (Di, J)), (Wdt, "Wdt", (R, Di)), (bdt, "bdt", (Di,)),
                           (A, "A", (Di, N)), (D_skip, "D_skip", (Di,))):
        _cuda.check(t, name, shape, f32, dev)
    _check_d_state(N, R)
    stream = _cuda.stream_of(xs)
    xc = torch.empty((B, L, Di), dtype=f32, device=dev)
    dbc = torch.empty((B, L, J), dtype=f32, device=dev)
    _cuda.launch("lfsr_mamba_front", xs.data_ptr(), sx, wconv.data_ptr(), bconv.data_ptr(),
                 Wx.data_ptr(), xc.data_ptr(), dbc.data_ptr(), B, L, Di, KC, J, code, stream)
    y = torch.empty((B, L, Di), dtype=xs.dtype, device=dev)
    _cuda.launch(
        "lfsr_scan_gate", xc.data_ptr(), dbc.data_ptr(), None, None, 0, None, 0,
        z.data_ptr(), sz, y.data_ptr(), Wdt.data_ptr(), bdt.data_ptr(), A.data_ptr(),
        D_skip.data_ptr(), B, L, Di, R, N, _FROM_DBC, _cuda.DTYPE_CODES[f32], code, stream,
    )
    mamba_inner_fused.launches += 1
    return y


@_cuda.counted
def mamba_inner_fused(xs, z, wconv, bconv, Wx, Wdt, bdt, A, D_skip):
    """K9c, the model's entry under ``scan_impl='fused'``: the kernels (the
    twin on the CPU); with a gradient wanted, through ``_cuda.PlainVJP`` (the
    twin's gradient, as ``_mi_bwd`` differentiates ``mamba_inner_ref``)."""
    args = (xs, z, wconv, bconv, Wx, Wdt, bdt, A, D_skip)
    if _cuda.wants_grad(*args):
        return _cuda.PlainVJP.apply(_mamba_inner, mamba_inner_plain, *args)
    return _mamba_inner(*args)


# --------------------------------------------------------------------------
# K9a: the op-level selective scan (pallas_scan.py::selective_scan_fused)
# --------------------------------------------------------------------------

def selective_scan_fused_plain(u, delta, A, Bc, Cc, D_skip=None, chunk=SCAN_CHUNK,
                               pre_softplus=False):
    """Plain twin of K9a, its forward as JAX computes it
    (pallas_scan.py:808-814): y = scan(u, softplus(delta) if ``pre_softplus``
    else delta, A, Bc, Cc) rounded to u.dtype, then, with ``D_skip``,
    (y + u D_skip) rounded again. The scan is :func:`selective_scan_chunked`
    at ``chunk``; at an L that is not a multiple of it (which JAX never
    runs) the log-depth :func:`selective_scan`, so the kernel can be held
    against it at any L."""
    f32 = torch.float32
    d = softplus(delta.to(f32)) if pre_softplus else delta
    if u.shape[1] % chunk == 0:
        y = selective_scan_chunked(u, d, A, Bc, Cc, None, chunk)
    else:
        y = selective_scan(u, d, A, Bc, Cc)
    if D_skip is not None:
        y = (y.to(f32) + u.to(f32) * D_skip.to(f32)).to(u.dtype)
    return y


def selective_scan_fused_grad_ref(u, delta, A, Bc, Cc, D_skip=None, chunk=SCAN_CHUNK,
                                  pre_softplus=False):
    """What K9a's gradient differentiates, JAX's ``_bwd`` reference
    (pallas_scan.py:824-836): :func:`selective_scan_chunked` with D inside
    (one rounding), which raises unless ``L % chunk == 0``."""
    d = softplus(delta.to(torch.float32)) if pre_softplus else delta
    return selective_scan_chunked(u, d, A, Bc, Cc, D_skip, chunk)


def _selective_scan_fused(u, delta, A, Bc, Cc, D_skip=None, chunk=SCAN_CHUNK,
                          pre_softplus=False):
    """K9a: kernel on CUDA tensors, plain twin on CPU tensors. The kernel
    takes u, delta, Bc and Cc in one dtype (Bc and Cc may be slices of a
    wider last axis), A and D_skip float32, and any L: ``chunk`` is a
    Pallas tiling parameter with no counterpart in it."""
    if _cuda.use_plain(u):
        return selective_scan_fused_plain(u, delta, A, Bc, Cc, D_skip, chunk, pre_softplus)
    B, L, Di = u.shape
    N = A.shape[1]
    dev, f32 = u.device, torch.float32
    code = _cuda.dtype_code(u, "u")
    _cuda.check(u, "u", (B, L, Di), u.dtype, dev)
    _cuda.check(delta, "delta", (B, L, Di), u.dtype, dev)
    sb = _cuda.row_stride(Bc, "Bc", (B, L, N), u.dtype, dev)
    sc = _cuda.row_stride(Cc, "Cc", (B, L, N), u.dtype, dev)
    _cuda.check(A, "A", (Di, N), f32, dev)
    if D_skip is not None:
        _cuda.check(D_skip, "D_skip", (Di,), f32, dev)
    _check_d_state(N)
    y = torch.empty_like(u)
    _cuda.launch(
        "lfsr_scan_given", u.data_ptr(), delta.data_ptr(), Bc.data_ptr(), sb, Cc.data_ptr(),
        sc, y.data_ptr(), A.data_ptr(), None if D_skip is None else D_skip.data_ptr(),
        B, L, Di, N, _GIVEN_RAW if pre_softplus else _GIVEN, code, _cuda.stream_of(u),
    )
    selective_scan_fused.launches += 1
    return y


@_cuda.counted
def selective_scan_fused(u, delta, A, Bc, Cc, D_skip=None, chunk=SCAN_CHUNK,
                         pre_softplus=False):
    """K9a, the op ``pallas_scan.selective_scan_fused`` (no model calls
    it): the kernel (its twin on the CPU); with a gradient wanted, through
    ``_cuda.PlainVJP`` with :func:`selective_scan_fused_grad_ref`'s
    gradient, as JAX's custom_vjp takes it through the chunked scan."""
    args = (u, delta, A, Bc, Cc, D_skip, chunk, pre_softplus)
    if _cuda.wants_grad(*args[:6]):
        return _cuda.PlainVJP.apply(_selective_scan_fused, selective_scan_fused_grad_ref, *args)
    return _selective_scan_fused(*args)

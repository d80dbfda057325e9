"""Plain PyTorch selective scan (port of lfsr_tpu/ops/selective_scan.py).

    h_t = exp(delta_t * A) * h_{t-1} + delta_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

is a first-order linear recurrence with an associative combine
(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2). :func:`selective_scan` runs it
as a log-depth Hillis-Steele scan over the whole sequence — the same
algorithm family as the JAX reference's ``associative_scan`` — in float32.
:func:`selective_scan_chunked` runs the same scan chunk by chunk, carrying
the [B, Di, N] state between chunks, each chunk's body under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``), so its autograd keeps
only the carries and not the log-depth [B, L, Di, N] intermediates (with no
gradient wanted, runs of chunks are scanned as one batch). They are the
oracles the scan kernels (``ops/scan.py``) are held against, and
the CPU path; autograd through them is the adjoint's oracle.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _combine(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive Hillis-Steele scan of (a, b) along axis 1: returns the
    running products of a and the states (zero initial state)."""
    L = a.shape[1]
    k = 1
    while k < L:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _coefficients(u, delta, A, Bc):
    """exp(delta A) and delta u B, [B, L, Di, N] float32."""
    f32 = torch.float32
    d32 = delta.to(f32)
    a = torch.exp(d32[..., None] * A.to(f32))
    b = (d32 * u.to(f32))[..., None] * Bc.to(f32)[:, :, None, :]
    return a, b


def scan_states(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor) -> torch.Tensor:
    """Every state h_t [B, L, Di, N] (float32) of the recurrence."""
    return _combine(*_coefficients(u, delta, A, Bc))[1]


def readout(h: torch.Tensor, u: torch.Tensor, Cc: torch.Tensor,
            D: torch.Tensor | None = None) -> torch.Tensor:
    """y = C . h (+ D u) in u.dtype, from the states of :func:`scan_states`."""
    y = torch.einsum("bldn,bln->bld", h, Cc.to(torch.float32))
    if D is not None:
        y = y + u.to(torch.float32) * D.to(torch.float32)
    return y.to(u.dtype)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor,
                   D: torch.Tensor | None = None) -> torch.Tensor:
    """u, delta [B, L, Di]; A [Di, N]; Bc, Cc [B, L, N]; D [Di].
    Returns y [B, L, Di] in u.dtype, computed in float32."""
    return readout(scan_states(u, delta, A, Bc), u, Cc, D)


# elements of one [B, chunks, chunk, Di, N] tensor when chunks run batched (no autograd)
GROUP_ELEMENTS = 1 << 25


def _chunks(h0, uc, dc, bc, cc, A, chunk):
    """G consecutive chunks ([B, G * chunk, ...] operands) from the carry h0
    [B, Di, N]: every chunk's log-depth scan in one batch, then the carries
    chunk by chunk, each injected into every position of its chunk. Returns
    (the last carry, C . h [B, G * chunk, Di]) in float32."""
    B, T, Di = uc.shape
    G, N = T // chunk, A.shape[1]
    fold = lambda t: t.reshape(B * G, chunk, t.shape[-1])
    aprod, h = (t.view(B, G, chunk, Di, N)
                for t in _combine(*_coefficients(fold(uc), fold(dc), A, fold(bc))))
    starts = []
    for g in range(G):  # the carry into chunk g, then out of it
        starts.append(h0)
        h0 = torch.addcmul(h[:, g, -1], aprod[:, g, -1], h0)
    h = h + aprod * torch.stack(starts, dim=1)[:, :, None]
    y = torch.einsum("bgldn,bgln->bgld", h, cc.reshape(B, G, chunk, N).to(torch.float32))
    return h0, y.reshape(B, T, Di)


def selective_scan_chunked(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                           Bc: torch.Tensor, Cc: torch.Tensor,
                           D: torch.Tensor | None = None, chunk: int = 256) -> torch.Tensor:
    """:func:`selective_scan` sequentially over L / ``chunk`` chunks, the
    log-depth scan inside each. ``L`` must be a multiple of ``chunk`` (JAX
    asserts it). With a gradient wanted each chunk body runs under
    ``checkpoint`` (non-reentrant): backward recomputes it, and only the
    [B, Di, N] carries are kept. Without one, runs of chunks up to
    ``GROUP_ELEMENTS`` per [B, chunks, chunk, Di, N] tensor are scanned as
    one batch, with the same arithmetic and a fraction of the launches."""
    B, L, Di = u.shape
    N = A.shape[1]
    if L % chunk:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    tensors = [t for t in (u, delta, A, Bc, Cc) if isinstance(t, torch.Tensor)]
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    step = chunk if remat else chunk * max(1, GROUP_ELEMENTS // (B * chunk * Di * N))
    h = u.new_zeros((B, Di, N), dtype=torch.float32)
    ys = []
    for t0 in range(0, L, step):
        parts = [t[:, t0 : t0 + step] for t in (u, delta, Bc, Cc)]
        if remat:
            h, yc = checkpoint(_chunks, h, *parts, A, chunk, use_reentrant=False)
        else:
            h, yc = _chunks(h, *parts, A, chunk)
        ys.append(yc)
    y = torch.cat(ys, dim=1)
    if D is not None:
        y = y + u.to(torch.float32) * D.to(torch.float32)
    return y.to(u.dtype)

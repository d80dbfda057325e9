"""Plain PyTorch selective scan (port of lfsr_tpu/ops/selective_scan.py).

    h_t = exp(delta_t * A) * h_{t-1} + delta_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

is a first-order linear recurrence with an associative combine
(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2). Here it runs as a log-depth
Hillis-Steele scan over the whole sequence — the same algorithm family as
the JAX reference's ``associative_scan`` — in float32. It is the oracle the
scan kernels (``ops/scan.py``) are held against, and the CPU path; autograd
through it is the adjoint's oracle.
"""

from __future__ import annotations

import torch


def scan_states(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor) -> torch.Tensor:
    """Every state h_t [B, L, Di, N] (float32) of the recurrence."""
    f32 = torch.float32
    d32 = delta.to(f32)
    a = torch.exp(d32[..., None] * A.to(f32))                       # [B, L, Di, N]
    b = (d32 * u.to(f32))[..., None] * Bc.to(f32)[:, :, None, :]   # [B, L, Di, N]
    L = u.shape[1]
    k = 1
    while k < L:  # inclusive Hillis-Steele scan along L
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


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

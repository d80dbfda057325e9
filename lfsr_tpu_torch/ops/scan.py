"""K1 — the Mamba selective scan with the dt projection folded in.

Port of lfsr_tpu/ops/pallas_scan.py::selective_scan_proj (Pallas kernel
``_scan_proj_kernel``). From the raw x_proj output
``dbc = [dt_low_rank | B | C]`` it computes

    delta = softplus(dbc[..., :R] @ Wdt + bdt)
    y = selective_scan(u, delta, A, dbc[..., R:R+N], dbc[..., R+N:], D_skip)

On a CUDA tensor :func:`selective_scan_proj` launches the hand-written
kernel (csrc/scan.cu); on a CPU tensor it runs the plain twin
:func:`selective_scan_proj_plain` (the port of ``scan_proj_ref``). The
kernel takes any L: the TPU's pad-to-a-multiple-of-128 (ssm.py:109-113) is
a Pallas tiling constraint with no counterpart here.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops import _cuda
from lfsr_tpu_torch.ops.selective_scan import selective_scan


def softplus(x: torch.Tensor) -> torch.Tensor:
    """logaddexp(x, 0): the form jax.nn.softplus (and the kernel) use."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan_proj_plain(u, dbc, Wdt, bdt, A, D_skip):
    """Plain twin of K1. u [B, L, Di]; dbc [B, L, R+2N]; Wdt [R, Di];
    bdt [Di]; A [Di, N] (negative); D_skip [Di]. Returns u.dtype."""
    f32 = torch.float32
    R, N = Wdt.shape[0], A.shape[1]
    d32 = dbc.to(f32)
    delta = softplus(d32[..., :R] @ Wdt.to(f32) + bdt.to(f32))
    return selective_scan(u, delta, A, d32[..., R : R + N], d32[..., R + N :], D_skip)


@_cuda.counted
def selective_scan_proj(u, dbc, Wdt, bdt, A, D_skip):
    """K1: kernel on CUDA tensors, plain twin on CPU tensors."""
    if _cuda.use_plain(u):
        return selective_scan_proj_plain(u, dbc, Wdt, bdt, A, D_skip)
    B, L, Di = u.shape
    R, N = Wdt.shape[0], A.shape[1]
    dev, f32 = u.device, torch.float32
    code = _cuda.dtype_code(u, "u")
    _cuda.check(u, "u", device=dev)
    _cuda.check(dbc, "dbc", (B, L, R + 2 * N), u.dtype, dev)
    _cuda.check(Wdt, "Wdt", (R, Di), f32, dev)
    _cuda.check(bdt, "bdt", (Di,), f32, dev)
    _cuda.check(A, "A", (Di, N), f32, dev)
    _cuda.check(D_skip, "D_skip", (Di,), f32, dev)
    if N not in (4, 8, 16, 32) or not 1 <= R <= 8:
        raise ValueError(f"scan kernel takes d_state in (4, 8, 16, 32) and dt_rank <= 8, "
                         f"got N={N}, R={R}")
    y = torch.empty_like(u)
    _cuda.launch(
        "lfsr_scan_proj", u.data_ptr(), dbc.data_ptr(), Wdt.data_ptr(), bdt.data_ptr(),
        A.data_ptr(), D_skip.data_ptr(), y.data_ptr(), B, L, Di, R, N, code,
        _cuda.stream_of(u),
    )
    selective_scan_proj.launches += 1
    return y

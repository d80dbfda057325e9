"""K13 — LayerNorm over the last axis, with the add of a position code
before it folded in (LFT's 16 LayerNorms a forward, EPIT's two a
transformer).

No TPU kernel matches it: JAX runs flax's LayerNorm, and the add of the
code before it, as XLA ops. In the port it was ``layer_norm_fast``'s chain
in float32 and a cast (~14 launches, each a pass over the token map), the
add one launch more; here it is one hand-written kernel
(csrc/layer_norm.cu) that reads the tokens once and writes the output once.

:func:`layer_norm` computes, for x [..., P, C] (float32 or bfloat16),

    s   = x if add is None else x + add
    out = layer_norm_fast(s, gamma, beta).to(out_dtype)

with torch's type promotion for the sum (bf16 + bf16 rounds to bf16, bf16 +
float32 stays float32), flax's statistics (float32, the fast variance
max(E[s^2] - E[s]^2, 0), eps 1e-6) and one rounding at the end. ``add`` is
None or [1, P, C] / [P, C] (row r of x takes row r mod P of it), gamma and
beta float32 [C], ``out_dtype`` float32 or bfloat16; C a multiple of 8 up
to :data:`MAX_C`. It raises ``ValueError`` for any other shape or dtype, on
every device.

On a CUDA tensor the wrapper launches the kernel and counts
``launches/K13`` (and ``launches/K13/code`` when it folds in an addend); on
a CPU tensor (or under ``_cuda.force_plain``) it runs the plain twin
:func:`layer_norm_plain`, the chain itself. With a gradient wanted it goes
through ``_cuda.PlainVJP``: the kernel forward, the twin's gradient (there
is no backward kernel), as K4-K12 do.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.ops import _cuda
from lfsr_tpu_torch.ops.cross_scan import EPS, layer_norm_fast

DTYPES = (torch.float32, torch.bfloat16)
VEC = 8  # channels a lane's 16-byte vector (bf16): C is a multiple of it
MAX_C = 32 * 4 * VEC  # 32 lanes of 4 vectors


def layer_norm_plain(x, gamma, beta, add, out_dtype):
    """The plain twin: the add (torch's promotion), ``layer_norm_fast``'s
    float32 chain, the cast to ``out_dtype``."""
    s = x if add is None else x + add
    return layer_norm_fast(s, gamma, beta).to(out_dtype)


def check_call(x, gamma, beta, add, out_dtype) -> None:
    """Raise ``ValueError`` unless K13 takes the call: x [..., P, C] and
    ``add`` (None, [1, P, C] or [P, C]) float32 or bfloat16, C a multiple of
    VEC up to MAX_C, gamma and beta float32 [C], ``out_dtype`` float32 or
    bfloat16."""
    if x.dim() < 2 or x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise ValueError(f"layer_norm: x [..., P, C] of {DTYPES} and an out_dtype of them; got "
                         f"{tuple(x.shape)} {x.dtype}, out_dtype {out_dtype}")
    P, C = x.shape[-2:]
    if C % VEC or not VEC <= C <= MAX_C:
        raise ValueError(f"layer_norm: C a multiple of {VEC} in [{VEC}, {MAX_C}]; got {C}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (C,):
            raise ValueError(f"layer_norm: {name} float32 [{C}]; got {tuple(t.shape)} {t.dtype}")
    if add is not None and (add.dtype not in DTYPES
                            or tuple(add.shape) not in ((1, P, C), (P, C))):
        raise ValueError(f"layer_norm: add [1, {P}, {C}] or [{P}, {C}] of {DTYPES}; got "
                         f"{tuple(add.shape)} {add.dtype}")


def _layer_norm(x, gamma, beta, add, out_dtype):
    if _cuda.use_plain(x):
        return layer_norm_plain(x, gamma, beta, add, out_dtype)
    dev = x.device
    x = x.contiguous()
    for name, t in (("gamma", gamma), ("beta", beta)):
        _cuda.check(t, name, device=dev)
    if add is not None:
        add = add.contiguous()
        _cuda.check(add, "add", device=dev)
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    if any(t.data_ptr() % 16 for t in (x, gamma, beta, out, *(() if add is None else (add,)))):
        raise ValueError("layer_norm: x, gamma, beta, add and the output must be 16-byte aligned")
    P, C = x.shape[-2:]
    _cuda.launch("lfsr_layer_norm", x.data_ptr(), None if add is None else add.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), x.numel() // C, C, P, EPS,
                 _cuda.DTYPE_CODES[x.dtype], -1 if add is None else _cuda.DTYPE_CODES[add.dtype],
                 _cuda.DTYPE_CODES[out_dtype], _cuda.stream_of(x))
    _cuda.launched("K13", None if add is None else "code")
    return out


@_cuda.counted("K13", ("code",))
def layer_norm(x, gamma, beta, add, out_dtype):
    """K13, the models' entry: x [..., P, C] -> [..., P, C] of ``out_dtype``;
    the kernel on a CUDA tensor, the plain twin on a CPU one; with a
    gradient wanted, the twin's gradient. Pass ``add`` (or None) and
    ``out_dtype`` by position: the benchmark counts the operands it logs."""
    check_call(x, gamma, beta, add, out_dtype)
    args = (x, gamma, beta, add, out_dtype)
    if _cuda.wants_grad(x, gamma, beta, add):
        return _cuda.PlainVJP.apply("K13", _layer_norm, layer_norm_plain, *args)
    return _layer_norm(*args)

"""K11 — the flagship's depthwise convolutions outside the blocks.

No TPU kernel matches it: JAX runs ``_dw_apply``
(``lfsr_tpu/models/lfmambax.py:57``) as XLA-fused elementwise ops and LSFL's
EPI convs as XLA grouped convs. In the port the first was ``dw_apply``'s
chain (a pad, 9 strided products, 8 adds: ~20 launches and ~44 passes over
the map) and the second cuDNN's grouped conv; both run here as one
hand-written stencil kernel (csrc/depthwise.cu) that reads the map once and
writes it once.

:func:`depthwise_conv` takes an NHWC map x of the compute dtype (float32 or
bfloat16; any C), the float32 weight [C, 1, kh, kw] of a conv whose groups
equal its channels ((kh, kw) in :data:`SHAPES`; rounded to x's dtype inside
the kernel, as ``.to(dt)`` does), its dilation (any, at least 1), zero
'same' padding, and one of two roundings (:data:`ROUNDINGS`), chosen by the
call site's form:

- ``"tap"``: the JAX ``_dw_apply`` form, ``dw_apply``'s chain bit for bit
  (each product rounded, the taps added in (ky, kx) order, a rounding after
  each add, the first tap taken as is);
- ``"once"``: a convolution's rounding, the taps summed in float32 and
  rounded once (``Conv.forward``'s ``F.conv2d``, within an ulp).

An optional bias [C] follows, rounded to the dtype and added in it, as
``Conv.forward`` adds it.

On a CUDA tensor the wrapper launches the kernel and counts
``launches/K11`` and ``launches/K11/<rounding>``; on a CPU tensor (or
under ``_cuda.force_plain``) it runs the plain twin
:func:`depthwise_plain`, the chain itself. With a gradient wanted it goes
through ``_cuda.PlainVJP``: the kernel forward, the twin's gradient (there
is no backward kernel), as K4-K10 do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lfsr_tpu_torch.ops import _cuda

# the kernel shapes the kernel takes, (kh, kw)
SHAPES = ((3, 3), (1, 3), (3, 1))
ROUNDINGS = ("tap", "once")
# the kernel's CTA (at most 128 registers a thread: two fit an SM), a CTA's
# shared memory at most, and an SM's (each CTA also takes 1 KB of it)
THREADS = 256
SMEM_BYTES = 227 * 1024
SM_SMEM_BYTES = 228 * 1024
CTAS_PER_SM = 2
# a thread's run of output rows down a column, its channels, and the
# channels of a staged tile at most (8 a thread)
RUN = 8
GROUP = 8
MAX_BLOCK = GROUP * THREADS
# output tiles (rows, columns) in the order the plan tries them: rows a
# multiple of RUN
TILES = tuple((th, tw) for tw in (32, 16, 8) for th in (16, 8))


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def same_padding(kernel, dilation) -> tuple[int, int]:
    """The zero padding that keeps H and W: d (k - 1) / 2 on each side."""
    (kh, kw), (dh, dw) = _pair(kernel), _pair(dilation)
    return dh * (kh - 1) // 2, dw * (kw - 1) // 2


def smem_bytes(tile, cs: int, itemsize: int, kernel, dilation, stages: int = 2) -> int:
    """Shared memory of a CTA: ``stages`` staged tiles of ``cs`` channels
    with their halo."""
    (th, tw), (kh, kw), (dh, dw) = tile, _pair(kernel), _pair(dilation)
    return stages * (th + (kh - 1) * dh) * (tw + (kw - 1) * dw) * cs * itemsize


def ctas_per_sm(smem: int) -> int:
    """CTAs of the kernel an SM holds with ``smem`` bytes each."""
    return min(CTAS_PER_SM, SM_SMEM_BYTES // (smem + 1024))


def _plans(cs: int, itemsize: int, kernel, dilation) -> list:
    """(tile, stages) of every tile in TILES whose staged copies fit a CTA."""
    return [(t, n) for t in TILES for n in (2, 1)
            if smem_bytes(t, cs, itemsize, kernel, dilation, n) <= SMEM_BYTES]


def channel_block(C: int, itemsize: int, kernel, dilation) -> int:
    """Channels a staged tile: C rounded up to a multiple of GROUP (all of
    the flagship's 64), or, where that passes MAX_BLOCK or no tile of it
    fits a CTA, the fewest equal blocks of a multiple of GROUP that fit.
    Raises where not even GROUP channels fit (a dilation in the hundreds)."""
    c8 = _up(C, GROUP)
    n = -(-c8 // MAX_BLOCK)
    while True:
        cs = _up(-(-c8 // n), GROUP)
        if _plans(cs, itemsize, kernel, dilation):
            return cs
        if cs == GROUP:
            raise ValueError(f"depthwise_conv: no tile of {GROUP} channels fits {SMEM_BYTES} "
                             f"bytes at kernel {_pair(kernel)}, dilation {_pair(dilation)}")
        n += 1


def tile_plan(cs: int, itemsize: int, kernel, dilation) -> tuple[int, int, int]:
    """(tile rows, tile columns, staged tiles) of a CTA for blocks of ``cs``
    channels: of the tiles whose staged copies fit SMEM_BYTES, the plan that
    puts the most CTAs on an SM, then the widest (a staged row is one run of
    contiguous pixels), then two tiles staged (the next one's copies in
    flight), then the tallest. Measured at the flagship's bf16 sites, the
    plans in turns on one card (PERF.md): at dilation 3, where two staged
    32-wide tiles leave one CTA an SM, 16 x 32 with one staged beats 8 x 16
    with two by 26% and 8 x 32 with two (one CTA) by 29%; at the other sites
    the plan is within 5% of the best plan tried. Raises where none fits."""
    plans = _plans(cs, itemsize, kernel, dilation)
    if not plans:
        raise ValueError(f"depthwise_conv: no tile fits {SMEM_BYTES} bytes at {cs} channels, "
                         f"{itemsize}-byte values, kernel {_pair(kernel)}, dilation "
                         f"{_pair(dilation)}")

    def rank(plan):
        (th, tw), n = plan
        ctas = ctas_per_sm(smem_bytes((th, tw), cs, itemsize, kernel, dilation, n))
        return (-ctas, -tw, -n, -th)

    (th, tw), n = min(plans, key=rank)
    return th, tw, n


def check_conv(channels: int, kernel, dilation, padding) -> None:
    """Raise unless the kernel takes a conv whose groups equal its
    ``channels``: (kh, kw) in SHAPES, a dilation of at least 1, 'same'
    padding, and a tile that fits in float32 (so in bfloat16 too). Every
    depthwise conv of LFMambaX passes; ``Conv`` checks at construction."""
    (kh, kw), (dh, dw) = _pair(kernel), _pair(dilation)
    if (kh, kw) not in SHAPES or dh < 1 or dw < 1 or _pair(padding) != same_padding(
            (kh, kw), (dh, dw)):
        raise ValueError(f"depthwise conv: K11 takes a kernel in {SHAPES}, a dilation >= 1 and "
                         f"'same' padding; got kernel {(kh, kw)}, dilation {(dh, dw)}, padding "
                         f"{_pair(padding)}")
    channel_block(channels, 4, (kh, kw), (dh, dw))


def depthwise_plain(x, weight, dilation, rounding: str, bias=None):
    """The plain twin, x's dtype throughout: ``"tap"`` is ``dw_apply``'s
    chain (zero pad, then the (ky, kx) products of strided slices and the
    taps, added in order, the first taken as is), ``"once"`` ``F.conv2d``
    with groups = C (the weight rounded first, as ``Conv.forward``)."""
    dt = x.dtype
    (dh, dw) = _pair(dilation)
    kh, kw = weight.shape[-2:]
    ph, pw = same_padding((kh, kw), (dh, dw))
    if rounding == "tap":
        wk = weight[:, 0].permute(1, 2, 0).to(dt)  # [kh, kw, C]
        xp = F.pad(x, (0, 0, pw, pw, ph, ph))
        H, W = x.shape[1], x.shape[2]
        y = None
        for ky in range(kh):
            for kx in range(kw):
                term = xp[:, ky * dh : ky * dh + H, kx * dw : kx * dw + W, :] * wk[ky, kx]
                y = term if y is None else y + term
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(dt), None, padding=(ph, pw),
                     dilation=(dh, dw), groups=x.shape[-1]).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def _depthwise_conv(x, weight, dilation, rounding: str, bias=None):
    if _cuda.use_plain(x):
        return depthwise_plain(x, weight, dilation, rounding, bias)
    code = _cuda.dtype_code(x, "x")
    dev = x.device
    x = x.contiguous()
    B, H, W, C = x.shape
    kernel, (dh, dw) = tuple(weight.shape[-2:]), _pair(dilation)
    check_conv(C, kernel, (dh, dw), same_padding(kernel, (dh, dw)))
    w = weight.to(torch.float32).contiguous()
    _cuda.check(w, "weight", (C, 1, *kernel), torch.float32, dev)
    b = None
    if bias is not None:
        b = bias.to(torch.float32).contiguous()
        _cuda.check(b, "bias", (C,), torch.float32, dev)
    y = torch.empty_like(x)
    if C % GROUP == 0 and (x.data_ptr() % 16 or y.data_ptr() % 16):
        raise ValueError("depthwise_conv: x and the output must be 16-byte aligned")
    cs = channel_block(C, x.element_size(), kernel, (dh, dw))
    plan = tile_plan(cs, x.element_size(), kernel, (dh, dw))
    _cuda.launch("lfsr_depthwise", x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), B, H, W, C, *kernel, dh, dw, cs, *plan,
                 ROUNDINGS.index(rounding), code, _cuda.stream_of(x))
    _cuda.launched("K11", rounding)
    return y


@_cuda.counted("K11", ROUNDINGS)
def depthwise_conv(x, weight, dilation, rounding: str, bias=None):
    """K11, the models' entry: x [B, H, W, C] (float32 or bfloat16) ->
    [B, H, W, C] of x's dtype; the kernel on a CUDA tensor, the plain twin
    on a CPU one; with a gradient wanted, the twin's gradient."""
    if rounding not in ROUNDINGS:
        raise ValueError(f"depthwise_conv: rounding in {ROUNDINGS}; got {rounding!r}")
    args = (x, weight, dilation, rounding, bias)
    if _cuda.wants_grad(x, weight, bias):
        return _cuda.PlainVJP.apply("K11", _depthwise_conv, depthwise_plain, *args)
    return _depthwise_conv(*args)

"""Plain PyTorch building blocks of the benchmark's reference models.

Everything here is float32 arithmetic on NHWC tensors, written from the
published descriptions of the models and of the light-field layouts. It
imports nothing of the program under test. A ``Prec`` object stands for
the precision the model states for its activations: the reference runs
with ``Prec("float32")`` (no rounding at all); a lower precision rounds
every activation and weight at the points where a model of that compute
dtype would hold them in it, which is how the benchmark's control is
computed (``Prec("float8")`` for a bfloat16 configuration).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


class Prec:
    """Rounding to a compute precision: ``float32`` (none), ``bfloat16``,
    ``float16`` or ``float8`` (e4m3, saturating)."""

    def __init__(self, name: str):
        if name not in ("float32", "bfloat16", "float16", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        if self.name == "float8":
            return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)
        return x.to(getattr(torch, self.name)).to(torch.float32)


F32 = Prec("float32")


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def mm(q: Prec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product of activations x and a weight w, both held in the compute
    precision, accumulated in float32 and rounded back to it."""
    return q(q(x) @ q(w))


def conv(q: Prec, x, weight, bias=None, padding=0, dilation=1, groups=1):
    """2-D convolution of NHWC x with an OIHW weight; the bias is added
    after rounding, as a layer of that compute dtype adds it."""
    y = F.conv2d(q(x).permute(0, 3, 1, 2), q(weight), None, padding=padding,
                 dilation=dilation, groups=groups)
    y = q(y.permute(0, 2, 3, 1))
    return y if bias is None else q(y + q(bias))


def pw(q: Prec, x, weight, bias=None):
    """1x1 convolution (OIHW weight [O, I, 1, 1]) as a product over channels."""
    y = mm(q, x, weight[:, :, 0, 0].t())
    return y if bias is None else q(y + q(bias))


def dw(q: Prec, x, weight, dilation: int = 1):
    """Depthwise KxK convolution (weight [C, 1, K, K]) with zero 'same'
    padding, its taps accumulated in row-major tap order in the compute
    precision."""
    k = weight.shape[-1]
    pad = dilation * (k - 1) // 2
    wk = q(weight[:, 0].permute(1, 2, 0))
    xp = F.pad(q(x), (0, 0, pad, pad, pad, pad))
    H, W = x.shape[1], x.shape[2]
    out = None
    for ky in range(k):
        for kx in range(k):
            term = q(xp[:, ky * dilation : ky * dilation + H, kx * dilation : kx * dilation + W]
                     * wk[ky, kx])
            out = term if out is None else q(out + term)
    return out


def layer_norm_fast(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis with the variance as E[x^2] - E[x]^2
    (clamped at 0), the form the models were trained with."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * gamma) + beta


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis with the centred two-pass variance."""
    xc = x - x.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma + beta


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC [B, H, W, C*r*r] -> [B, H*r, W*r, C]; output channel c at
    sub-pixel (i, j) reads input channel c*r*r + i*r + j."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def bicubic(x: torch.Tensor, s: int) -> torch.Tensor:
    """Bicubic upsampling (a = -0.75, half-pixel centres) of NCHW x."""
    return F.interpolate(x, scale_factor=s, mode="bicubic", align_corners=False)


# light-field layouts: an SAI mosaic [..., U*h, V*w] tiles the U x V views;
# a MacPI image [..., h*U, w*V] holds at each pixel its U x V macro-pixel

def sai_to_views(x: torch.Tensor, ang: int) -> torch.Tensor:
    *lead, H, W = x.shape
    return x.reshape(*lead, ang, H // ang, ang, W // ang).movedim(-3, -2)


def views_to_sai(x: torch.Tensor) -> torch.Tensor:
    *lead, U, V, h, w = x.shape
    return x.movedim(-2, -3).reshape(*lead, U * h, V * w)


def sai_to_macpi(x: torch.Tensor, ang: int) -> torch.Tensor:
    v = sai_to_views(x, ang)  # [..., U, V, h, w]
    *lead, U, V, h, w = v.shape
    n = len(lead)
    return v.permute(*range(n), n + 2, n, n + 3, n + 1).reshape(*lead, h * U, w * V)


def macpi_to_sai(x: torch.Tensor, ang: int) -> torch.Tensor:
    *lead, H, W = x.shape
    n = len(lead)
    v = x.reshape(*lead, H // ang, ang, W // ang, ang).permute(*range(n), n + 1, n + 3, n, n + 2)
    return views_to_sai(v)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------

def _inclusive(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of the affine maps h -> a h + b along ``dim`` (zero
    initial state), log-depth. Returns (running products, states)."""
    n = a.shape[dim]
    k = 1
    while k < n:
        a_lo, a_hi = a.narrow(dim, 0, n - k), a.narrow(dim, k, n - k)
        b_lo, b_hi = b.narrow(dim, 0, n - k), b.narrow(dim, k, n - k)
        b = torch.cat([b.narrow(dim, 0, k), a_hi * b_lo + b_hi], dim=dim)
        a = torch.cat([a.narrow(dim, 0, k), a_hi * a_lo], dim=dim)
        k *= 2
    return a, b


def _scan_group(h0, u, delta, A, Bc, Cc, chunk: int):
    """A run of whole chunks [B, G*chunk, .] from the state h0 [B, Di, N]:
    each chunk scanned log-depth, the chunks' end maps scanned log-depth
    across the run, the carries injected. Returns (last state, C . h)."""
    B, T, Di = u.shape
    G, N = T // chunk, A.shape[1]
    a = torch.exp(delta[..., None] * A).reshape(B, G, chunk, Di, N)
    b = ((delta * u)[..., None] * Bc[:, :, None, :]).reshape(B, G, chunk, Di, N)
    a, b = _inclusive(a, b, 2)
    a_end, b_end = a[:, :, -1], b[:, :, -1]  # [B, G, Di, N]
    b_end = torch.cat([b_end[:, :1] + a_end[:, :1] * h0[:, None], b_end[:, 1:]], dim=1)
    _, ends = _inclusive(a_end, b_end, 1)  # the state at each chunk's end
    carry = torch.cat([h0[:, None], ends[:, :-1]], dim=1)  # into each chunk
    h = b + a * carry[:, :, None]
    y = torch.einsum("bgtdn,bgtn->bgtd", h, Cc.reshape(B, G, chunk, N))
    return ends[:, -1], y.reshape(B, T, Di)


def selective_scan(u, delta, A, Bc, Cc, D=None, chunk: int = 64, group: int = 1 << 25,
                   remat: bool = False):
    """y_t = C_t . h_t (+ D u_t) with h_t = exp(delta_t A) h_{t-1} +
    delta_t B_t u_t, h_0 = 0; float32. u, delta [B, L, Di]; A [Di, N];
    Bc, Cc [B, L, N]. L is padded with identity steps to whole chunks; runs
    of chunks of about ``group`` states go one at a time, each under
    ``torch.utils.checkpoint`` when ``remat`` (training: only the [B, Di,
    N] carries are kept for the backward)."""
    B, L, Di = u.shape
    N = A.shape[1]
    pad = -L % chunk
    if pad:
        u, delta, Bc, Cc = (F.pad(t, (0, 0, 0, pad)) for t in (u, delta, Bc, Cc))
    step = chunk * max(1, group // (B * chunk * Di * N))
    h = u.new_zeros((B, Di, N))
    ys = []
    for t0 in range(0, L + pad, step):
        parts = [t[:, t0 : t0 + step] for t in (u, delta, Bc, Cc)]
        if remat:
            h, y = torch.utils.checkpoint.checkpoint(
                _scan_group, h, parts[0], parts[1], A, parts[2], parts[3], chunk,
                use_reentrant=False)
        else:
            h, y = _scan_group(h, parts[0], parts[1], A, parts[2], parts[3], chunk)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    if D is not None:
        y = y + u[:, :L] * D
    return y


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# evaluation geometry: whole-scene padding and the tiled protocol
# ---------------------------------------------------------------------------

def symmetric_index(size: int, before: int, after: int) -> np.ndarray:
    """Source indices of an axis extended by whole-sample mirroring (the
    edge sample repeated), ``before`` and ``after`` samples."""
    return np.pad(np.arange(size), (before, after), mode="symmetric")


def whole_pad(sai: torch.Tensor, ang: int, pad: int):
    """Mirror-extend each view of an SAI mosaic [A*h0, A*w0] by p =
    min(pad, h0 - 8, w0 - 8) pixels, the bottom and right pads taking each
    padded view up to a multiple of 8. Returns (mosaic, p)."""
    H, W = sai.shape
    h0, w0 = H // ang, W // ang
    p = min(pad, max(h0 - 8, 0), max(w0 - 8, 0))
    if p == 0:
        return sai, 0
    pb, pr = p + (-(h0 + 2 * p) % 8), p + (-(w0 + 2 * p) % 8)
    hi = torch.from_numpy(symmetric_index(h0, p, pb)).to(sai.device)
    wi = torch.from_numpy(symmetric_index(w0, p, pr)).to(sai.device)
    v = sai.reshape(ang, h0, ang, w0).index_select(1, hi).index_select(3, wi)
    return v.reshape(ang * (h0 + p + pb), ang * (w0 + p + pr)), p


def tile_grid(h0: int, w0: int, patch: int, stride: int) -> tuple[int, int]:
    bdr = (patch - stride) // 2
    return (h0 + 2 * bdr - 1) // stride, (w0 + 2 * bdr - 1) // stride


def divide(sai: torch.Tensor, ang: int, patch: int, stride: int) -> torch.Tensor:
    """Overlapping SAI patches [n1*n2, A*patch, A*patch] of a mosaic
    [A*h0, A*w0]: each view mirror-extended by (patch - stride)/2 before
    and that plus stride - 1 after, then cut every ``stride`` pixels."""
    views = sai_to_views(sai, ang)
    h0, w0 = views.shape[-2:]
    n1, n2 = tile_grid(h0, w0, patch, stride)
    bdr = (patch - stride) // 2

    def index(n, size):
        ext = symmetric_index(size, bdr, bdr + stride - 1)
        idx = (np.arange(n) * stride)[:, None] + np.arange(patch)[None, :]
        return torch.from_numpy(ext[idx.reshape(-1)]).to(sai.device)

    x = views.index_select(-2, index(n1, h0)).index_select(-1, index(n2, w0))
    x = x.reshape(ang, ang, n1, patch, n2, patch).permute(2, 4, 0, 1, 3, 5)
    return views_to_sai(x).reshape(n1 * n2, ang * patch, ang * patch)


def integrate(patches: torch.Tensor, ang: int, patch: int, stride: int, h: int, w: int):
    """Views [A, A, h, w] from SR patches [n1*n2, A*patch, A*patch] (sizes
    in output pixels): each patch's centre stride x stride block."""
    bdr = (patch - stride) // 2
    n1, n2 = tile_grid(h, w, patch, stride)
    x = patches.reshape(n1, n2, ang, patch, ang, patch).movedim(-2, 3)
    x = x[..., bdr : bdr + stride, bdr : bdr + stride]
    x = x.permute(2, 3, 0, 4, 1, 5).reshape(ang, ang, n1 * stride, n2 * stride)
    return x[..., :h, :w]


def lecun_std(shape) -> float:
    """Standard deviation of a lecun-normal draw truncated at two of them:
    variance 1 / fan_in after the truncation."""
    return math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978

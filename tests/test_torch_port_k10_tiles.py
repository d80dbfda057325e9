"""K10's kernels plan their tiles, halos and warps in csrc/hlfr_tail.cu;
pin the plan on the CPU.

Both kernels walk tiles of TH x TW output pixels (``ops/head.TAIL_TILES``,
the tile the wrapper passes and the kernel checks: 16 x 30 for the bf16
tensor-core kernel, 16 x 16 for the float32 one) in the order of
``tile_origin`` and stage the tile's halo, (TH + 2) x (TW + 2) pixels of
y starting one pixel up and left, zeros outside the image. Halo row r is
pixel (y0 - 1 + r / (TW + 2), x0 - 1 + r % (TW + 2)); ``shifted_adds``
reads output (oy, ox)'s tap k = 3 ky + kx from halo row (oy + ky) (TW + 2)
+ ox + kx. The bf16 kernel's 576 halo rows are 36 m-tiles of 16, warp w
taking m-tiles w, w + 12 and w + 24. The numpy models below check that
every output pixel is written by exactly one tile, that the halo rows a
pixel reads are its 3 x 3 neighbourhood (zero outside the image), that the
m-tiles split evenly over the warps, that the plan computes
``hlfr_tail_plain`` (float32, numpy), that the kernel's lrelu on bf16 bits
(one rounding of both sums, an integer choice by the sign bits) equals
torch's ``where(z >= 0, z, slope * z)`` on bf16 bit for bit, and that the
shared memory fits at every width. The wrapper's launch plan is read with
``_cuda``'s checks and launch replaced by recorders: which tile each dtype
and width takes.
"""

import numpy as np
import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.models.lfmambax import fold_out_conv
from lfsr_tpu_torch.ops import _cuda, head

from _torch_port import one_torch_thread  # noqa: F401

MMA_WARPS, TAPS, NT = 12, 36, 5  # tail_mma_kernel: warps, W36's columns, its n-tiles
SMEM_LIMIT = 232_448  # bytes a block may use
SIZES = [(1, 1), (16, 30), (17, 31), (37, 53), (160, 160), (1440, 1440), (1280, 1760)]


def tiles(B, H, W, th, tw):
    """``tile_origin`` for every tile: arrays of (b, y0, x0)."""
    ty, tx = -(-H // th), -(-W // tw)
    t = np.arange(B * ty * tx)
    b, r = t // (ty * tx), t % (ty * tx)
    return b, (r // tx) * th, (r % tx) * tw


def halo_pixel(y0, x0, r, tw):
    """The image pixel of halo row r of the tile at (y0, x0)."""
    return y0 - 1 + r // (tw + 2), x0 - 1 + r % (tw + 2)


@pytest.mark.parametrize("path", ["mma", "f32"])
@pytest.mark.parametrize("H,W", SIZES, ids=[f"{a}x{b}" for a, b in SIZES])
def test_every_output_written_once_from_its_neighbourhood(H, W, path):
    th, tw = head.TAIL_TILES[path]
    B = 2
    b, y0, x0 = tiles(B, H, W, th, tw)
    oy, ox = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    gy, gx = y0[:, None, None] + oy, x0[:, None, None] + ox  # [tile, th, tw]
    inside = (gy < H) & (gx < W)  # shifted_adds' bound
    seen = np.zeros((B, H, W), np.int64)
    np.add.at(seen, (np.broadcast_to(b[:, None, None], gy.shape)[inside], gy[inside],
                     gx[inside]), 1)
    assert (seen == 1).all()
    for ky in range(3):
        for kx in range(3):
            r = (oy + ky) * (tw + 2) + ox + kx
            assert r.max() < (th + 2) * (tw + 2)
            hy, hx = halo_pixel(y0[:, None, None], x0[:, None, None], r, tw)
            assert (hy == gy + ky - 1).all() and (hx == gx + kx - 1).all()


def test_mma_tile_is_twelve_warps_of_three_m_tiles():
    th, tw = head.TAIL_TILES["mma"]
    rows = (th + 2) * (tw + 2)
    assert (th, tw, rows) == (16, 30, 576) and rows % 16 == 0
    per_warp = rows // 16 // MMA_WARPS
    m_tiles = [w + mi * MMA_WARPS for w in range(MMA_WARPS) for mi in range(per_warp)]
    assert per_warp == 3 and sorted(m_tiles) == list(range(rows // 16))
    # the tile's work on its halo: 1.2 times its own pixels'
    assert rows / (th * tw) == 1.2


def mma_smem(C, Cz):
    """``mma_smem``: w1^T [Cz][C + 8], W36^T [NT 8][Cz + 8] (bf16) and two
    halo buffers, each the larger of y [576][C + 8] bf16 and t [576][36]
    float32."""
    th, tw = head.TAIL_TILES["mma"]
    rows = (th + 2) * (tw + 2)
    buf = max(rows * (C + 8) * 2, rows * TAPS * 4)
    return Cz * (C + 8) * 2 + NT * 8 * (Cz + 8) * 2 + 2 * buf


def test_shared_memory_fits_at_every_width():
    """One CTA an SM at every width, Cz = 4 C (rr 4); at C 64 the y buffer
    is exactly t's 82,944 bytes and the whole is 223,872."""
    for C in head.TAIL_CHANNELS:
        assert mma_smem(C, 4 * C) <= SMEM_LIMIT
    assert mma_smem(64, 256) == 36_864 + 21_120 + 2 * 82_944 == 223_872


def plan_forward(y, w1, kf, bias, th, tw, slope=0.1):
    """The kernels' function through their plan, float32 numpy: z and t on
    each tile's zero-filled halo, then the nine shifted adds (bias first,
    k = 0..8) for the tile's pixels."""
    B, H, W, C = y.shape
    Cz = w1.shape[1]
    w36 = kf.transpose(2, 0, 1, 3).reshape(Cz, TAPS)  # column k rr + j
    out = np.full((B, H, W, 4), np.nan, np.float32)
    rows = np.arange((th + 2) * (tw + 2))
    for b, y0, x0 in zip(*tiles(B, H, W, th, tw)):
        hy, hx = halo_pixel(y0, x0, rows, tw)
        inside = (hy >= 0) & (hy < H) & (hx >= 0) & (hx < W)
        yh = np.zeros((rows.size, C), np.float32)
        yh[inside] = y[b, hy[inside], hx[inside]]
        z = yh @ w1
        t = np.where(z >= 0, z, slope * z) @ w36
        for oy in range(th):
            for ox in range(tw):
                if y0 + oy >= H or x0 + ox >= W:
                    continue
                v = np.full(4, bias[0], np.float32)
                for k in range(9):
                    ky, kx = divmod(k, 3)
                    v = v + t[(oy + ky) * (tw + 2) + ox + kx, 4 * k : 4 * k + 4]
                out[b, y0 + oy, x0 + ox] = v
    return out


@pytest.mark.parametrize("path", ["mma", "f32"])
@pytest.mark.parametrize("H,W", [(37, 53), (17, 31)], ids=["37x53", "17x31"])
def test_the_plan_computes_the_twin(H, W, path):
    """float32, C 16, Cz 64: within 1e-5 of the plain twin's scale."""
    g = torch.Generator().manual_seed(H * W)
    C = 16
    y = torch.randn(2, H, W, C, generator=g)
    w1 = torch.randn(C, 4 * C, generator=g) * C**-0.5
    kf = fold_out_conv(torch.randn(3, 3, C, 1, generator=g) * 0.1, 2)
    bias = torch.randn(1, generator=g) * 0.1
    got = plan_forward(y.numpy(), w1.numpy(), kf.numpy(), bias.numpy(), *head.TAIL_TILES[path])
    want = head.hlfr_tail_plain(y, w1, kf, bias).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def lrelu_pack(lo, hi, slope):
    """csrc/hlfr_tail.cu ``lrelu_pack`` on bits: both sums rounded to bf16 by
    one cvt (round to nearest even), slope * z in float32 rounded again,
    each half chosen by its sign bit."""
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().astype(
        np.uint32) & 0xFFFF
    zlo, zhi = bf(lo), bf(hi)
    zb = zlo | (zhi << 16)
    flo = (zb << 16).astype(np.uint32).view(np.float32)
    fhi = (zb & 0xFFFF0000).astype(np.uint32).view(np.float32)
    mb = bf(np.float32(slope) * flo) | (bf(np.float32(slope) * fhi) << 16)
    neg = (((zb >> 15) & 0x00010001) * 0xFFFF).astype(np.uint32)
    return (zb & ~neg) | (mb & neg)


def test_lrelu_bits_equal_torch_on_bf16():
    """The kernel's lrelu of a pair of float32 sums equals torch's
    where(z >= 0, z, slope * z) on z rounded to bf16, bit for bit: random
    sums over many scales, ties, zeros of both signs, tiny and large."""
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.standard_normal(200_000) * 10.0 ** rng.integers(-30, 30, 200_000),
        [0.0, -0.0, 1e-38, -1e-38, 1e-45, -1e-45, 3e38, -3e38, 1.0 + 2**-8, -(1.0 + 2**-8),
         1.0 + 3 * 2**-8, -1.5 - 2**-8],
    ]).astype(np.float32)
    v = v[: v.size // 2 * 2]
    lo, hi = v[0::2], v[1::2]
    for slope in (0.1, 0.2, 0.01):
        got = lrelu_pack(lo, hi, slope)
        z = torch.from_numpy(v).to(torch.bfloat16)
        want = torch.where(z >= 0, z, slope * z).view(torch.int16).numpy().astype(np.uint32)
        want = (want[0::2] & 0xFFFF) | ((want[1::2] & 0xFFFF) << 16)
        assert np.array_equal(got, want), slope


# ---- the wrapper's launch plan, without a card --------------------------------

@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("C", head.TAIL_CHANNELS)
@pytest.mark.parametrize("dtype,path", [(torch.bfloat16, "mma"), (torch.float32, "f32")])
def test_k10_launch_by_dtype_and_width(launches, dtype, path, C):
    g = torch.Generator().manual_seed(6)
    B, H, W = 2, 37, 53
    args = (torch.randn(B, H, W, C, generator=g).to(dtype), torch.randn(C, 4 * C, generator=g),
            fold_out_conv(torch.randn(3, 3, C, 1, generator=g), 2), torch.randn(1, generator=g))
    n = trace.counter("launches/K10")
    out = head.hlfr_tail(*args)
    ((name, a),) = launches
    assert head.kernel_path(dtype) == path and trace.counter("launches/K10") == n + 1
    assert name == "lfsr_hlfr_tail" and out.shape == (B, H, W, 4)
    assert a[5:12] == (B, H, W, C, 4 * C, *head.TAIL_TILES[path])
    assert a[-2] == _cuda.DTYPE_CODES[dtype]

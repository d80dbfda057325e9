"""K5's tensor-core kernel reads seq through a tile -> position map; pin it
on the CPU.

``scatter_mma_kernel`` (csrc/cross_scan.cu) walks tiles of th x tw pixels
(``ops/cross_scan.scatter_tile``, the tile the wrapper passes to the
kernel) in the order of its ``tile_origin`` and copies channel quarter q
of each pixel from sequence position ``seq_index(q, hh, ww)``, thread i
taking pixel (i / tw, i % tw) of the tile for quarters 0 and 1 and
(i % th, i / th) for 2 and 3. ``tile_reads`` below is that loop in numpy.
For maps of 17 x 23, 160 x 160, 640 x 880 and 720 x 720 and several tiles
it must read every (pixel, quarter) exactly once, give what ``_unpermute``
gives, and read each quarter of a tile in runs of consecutive positions
(forwards for quarters 0 and 2, backwards for 1 and 3), one run a tile row
(0, 1) or column (2, 3). The wrapper's launch plan is read with ``_cuda``'s
checks and launch replaced by recorders: which kernel each dtype and C
takes, and with which tile.
"""

import numpy as np
import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import _cuda, cross_scan

from _torch_port import one_torch_thread  # noqa: F401

MAPS = [(17, 23), (160, 160), (640, 880), (720, 720)]
# the wrapper's tiles at 64 and 128 channels, and others the kernel takes
# (tw a multiple of 16)
TILES = sorted({cross_scan.scatter_tile(64), cross_scan.scatter_tile(128), (32, 32), (8, 32),
                (3, 16)})


def seq_index(q, hh, ww, H, W):
    """csrc/cross_scan.cu ``seq_index``: the position quarter q reads at
    pixel (hh, ww)."""
    L = H * W
    rm, cm = hh * W + ww, ww * H + hh
    return {0: rm, 1: L - 1 - rm, 2: cm, 3: L - 1 - cm}[q]


def tile_reads(B, H, W, th, tw):
    """The kernel's copy loop for every tile (``tile_origin``: tile t ->
    batch row t / (ty tx), tile row, tile column) and quarter: arrays
    [tiles, th tw] of b, hh, ww and the position l read by thread slot i
    (in order), and the mask of pixels inside the map."""
    ty, tx = -(-H // th), -(-W // tw)
    t = np.arange(B * ty * tx)[:, None]
    b, r = t // (ty * tx), t % (ty * tx)
    y0, x0 = (r // tx) * th, (r % tx) * tw
    k = np.arange(th * tw)[None, :]
    out = {}
    for q in range(4):
        py, px = (k // tw, k % tw) if q < 2 else (k % th, k // th)
        hh, ww = y0 + py, x0 + px
        inside = (hh < H) & (ww < W)
        l = np.where(inside, seq_index(q, hh, ww, H, W), -1)
        out[q] = (np.broadcast_to(b, l.shape), hh, ww, l, inside)
    return out


@pytest.mark.parametrize("tile", TILES, ids=[f"{a}x{b}" for a, b in TILES])
@pytest.mark.parametrize("H,W", MAPS, ids=[f"{a}x{b}" for a, b in MAPS])
def test_every_pixel_and_quarter_read_once_in_runs(H, W, tile):
    th, tw = tile
    B = 2
    reads = tile_reads(B, H, W, th, tw)
    seen = np.zeros(B * H * W * 4, np.int64)
    for q, (b, hh, ww, l, inside) in reads.items():
        np.add.at(seen, (((b * H + hh) * W + ww) * 4 + q)[inside], 1)
        # runs: consecutive slots of a tile row (q 0, 1) or column (q 2, 3)
        # read consecutive positions, forwards for 0 and 2, backwards for 1, 3
        run = tw if q < 2 else th
        step = 1 if q in (0, 2) else -1
        same_run = ((np.arange(th * tw - 1) + 1) % run != 0)[None, :]
        both = inside[:, :-1] & inside[:, 1:] & same_run
        assert (np.diff(l, axis=1)[both] == step).all()
        # and a run breaks only where the tile or the map ends
        assert both.sum() == (inside.sum(axis=1) - _runs(inside, run)).sum()
    assert (seen == 1).all()


def _runs(inside, run):
    """Runs per tile: the non-empty runs of ``run`` slots."""
    return inside.reshape(inside.shape[0], -1, run).any(axis=2).sum(axis=1)


@pytest.mark.parametrize("tile", [cross_scan.scatter_tile(16), (8, 32), (3, 16)],
                         ids=["plan", "8x32", "3x16"])
@pytest.mark.parametrize("H,W", MAPS, ids=[f"{a}x{b}" for a, b in MAPS])
def test_tile_reads_equal_unpermute(H, W, tile):
    """z gathered through the kernel's map is ``_unpermute(seq)`` (C 16:
    quarters of 4 channels, the kernel's 8-byte copies)."""
    th, tw = tile
    B, C = 2, 16
    g = C // 4
    seq = torch.randn(B, H * W, C, generator=torch.Generator().manual_seed(H + W))
    z = torch.full((B, H, W, C), float("nan"))
    for q, (b, hh, ww, l, inside) in tile_reads(B, H, W, th, tw).items():
        b, hh, ww, l = (torch.from_numpy(np.ascontiguousarray(a[inside])) for a in (b, hh, ww, l))
        z[b, hh, ww, q * g : (q + 1) * g] = seq[b, l, q * g : (q + 1) * g]
    assert torch.equal(z, cross_scan._unpermute(seq, H, W))


def test_scatter_tile_plan():
    """16 x 16 pixels up to 64 channels, 8 x 16 above; tw a multiple of 16
    (a warp's m-tile is 16 pixels of a tile row)."""
    for c in range(16, 129, 16):
        th, tw = cross_scan.scatter_tile(c)
        assert (th, tw) == ((16, 16) if c <= 64 else (8, 16))
        assert tw % 16 == 0


# ---- the wrapper's launch plan, without a card --------------------------------

@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("dtype,C,path", [
    (torch.bfloat16, 64, "mma"), (torch.bfloat16, 16, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 20, "fma"), (torch.float32, 64, "fma")])
def test_k5_launch_by_dtype_and_width(launches, dtype, C, path):
    g = torch.Generator().manual_seed(4)
    B, H, W = 2, 17, 23
    args = (torch.randn(B, H * W, C, generator=g).to(dtype),
            torch.randn(B, H, W, C, generator=g).to(dtype),
            torch.randn(C, C, generator=g).to(dtype), torch.full((1,), 0.15))
    before = trace.counts("launches/K5/")
    cross_scan.cross_scan_scatter(*args)
    ((name, a),) = launches
    assert cross_scan.kernel_path(dtype, C) == path
    assert trace.counts("launches/K5/") == {k: v + (k == path) for k, v in before.items()}
    if path == "mma":
        assert name == "lfsr_cross_scan_scatter_mma"
        assert a[5:11] == (B, H, W, C, *cross_scan.scatter_tile(C))
    else:
        assert name == "lfsr_cross_scan_scatter"
        assert a[5:10] == (B, H, W, C, _cuda.DTYPE_CODES[dtype])

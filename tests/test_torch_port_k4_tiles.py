"""K4's tile kernel reads x through a tile -> (quarter, source pixel) map;
pin it on the CPU.

``gather_tile_kernel`` (csrc/cross_scan.cu) walks tiles of T consecutive
sequence positions of one image (``tile_origin``: tile t -> image t / tpi,
j = t % tpi, tpi = ceil(L / T); the image's tiles from both ends in turn,
first position T j / 2 for even j, T (tpi - 1 - j / 2) for odd j). Copy i
of quarter q takes
granule i % NQ of position l = l0 + i / NQ, reads the pixel whose
quarter-q sequence index is l (raster index l for quarters 0 and 2,
L - 1 - l for 1 and 3; row-major for 0 and 1, column-major for 2 and 3),
dividing by W or H with ``lfsr::FastDiv`` (a 32-bit multiply-high), and
stores it in row i / NQ of the tile. ``tile_copies`` below is that loop in
numpy. On maps of 17 x 23, 160 x 160, 640 x 880 and 720 x 720 and several
tile sizes it must read every (position, quarter, granule) exactly once,
give what ``_permute`` gives, and read each quarter in runs: forwards along
raster rows (quarter 0), backwards (1), down columns forwards (2) and
backwards (3). ``Layout`` mirrors the kernel's granules and LayerNorm
groups; LayerNorm over a staged row by those groups equals the plain
twin. The wrapper's launch plan is read with ``_cuda``'s checks and launch
replaced by recorders: which kernel each dtype and width takes, with how
many positions a tile.
"""

import numpy as np
import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import _cuda, cross_scan

MAPS = [(17, 23), (160, 160), (640, 880), (720, 720)]
THREADS = 256  # gather_tile::kThreads


def fast_div_params(d: int) -> tuple[int, int]:
    """``lfsr::FastDiv(d)``: (m, s) with n / d = umulhi(n, m) >> s."""
    if d == 1:
        return 0, 0
    l = 0
    while (1 << l) < d:
        l += 1
    return ((1 << (31 + l)) + d - 1) // d, l - 1


def fast_div(n, d: int):
    """``FastDiv::div`` on uint32 arithmetic (n an int64 array, n < 2^31)."""
    m, s = fast_div_params(d)
    if d == 1:
        return n
    return ((n.astype(np.uint64) * np.uint64(m)) >> np.uint64(32 + s)).astype(np.int64)


def layout(esize: int, C: int) -> dict:
    """``gather_tile::Layout<E, C>``: quarter G elements (GB bytes) in
    granules of ``gran`` bytes (``vec`` elements, NQ a quarter), a staged
    row of LDS elements; LayerNorm reads a row's N granules M a thread,
    groups of P lanes, ``rows`` rows a pass of 256 threads."""
    G = C // 4
    GB = G * esize
    gran = 16 if GB % 16 == 0 else 8
    NQ, N = GB // gran, 4 * (GB // gran)
    M = 2 if N > 32 else 1
    P = next(p for p in (4, 8, 16, 32) if p >= N // M)
    return dict(G=G, GB=GB, gran=gran, vec=gran // esize, NQ=NQ, LDS=C + G, N=N, M=M, P=P,
                rows=THREADS // P)


def tile_copies(B, H, W, C, esize, T):
    """The kernel's copy loop for every tile and quarter: q -> (b, l, hh, ww,
    first channel c0, row k, valid), arrays [tiles, T NQ] in copy order i."""
    Y = layout(esize, C)
    L = H * W
    tpi = -(-L // T)
    t = np.arange(B * tpi)[:, None]
    b, j = t // tpi, t % tpi
    l0 = np.where(j & 1, tpi - 1 - j // 2, j // 2) * T
    i = np.arange(T * Y["NQ"])[None, :]
    k, part = i // Y["NQ"], i % Y["NQ"]
    l = l0 + k
    valid = l < L  # i < n NQ with n = min(T, L - l0)
    out = {}
    for q in range(4):
        li = np.where(valid, (L - 1 - l) if q & 1 else l, 0)
        if q < 2:
            hh = fast_div(li, W)
            ww = li - hh * W
        else:
            ww = fast_div(li, H)
            hh = li - ww * H
        c0 = q * Y["G"] + part * Y["vec"]
        out[q] = tuple(np.broadcast_to(a, valid.shape) for a in (b, l, hh, ww, c0, k, valid))
    return out


def test_fast_div_equals_integer_division():
    """Exhaustive over every raster index of each map's H and W, and random
    dividends below 2^31 for random divisors up to 2^31 - 1."""
    for H, W in MAPS:
        n = np.arange(H * W, dtype=np.int64)
        for d in (H, W):
            assert (fast_div(n, d) == n // d).all(), d
    rng = np.random.default_rng(0)
    n = np.concatenate([rng.integers(0, 2**31, 20000), [0, 1, 2**31 - 1, 2**30, 2**31 - 2]])
    for d in [1, 2, 3, 7, 64, 65, 160, 720, 880, 2**16 + 1, 2**30, 2**31 - 1,
              *rng.integers(2, 2**31, 40)]:
        d = int(d)
        assert (fast_div(n, d) == n // d).all(), d
        m, _ = fast_div_params(d)
        assert m < 2**32


@pytest.mark.parametrize("T", [64, 128, 256])
@pytest.mark.parametrize("H,W", MAPS, ids=[f"{a}x{b}" for a, b in MAPS])
def test_every_position_and_quarter_read_once_in_runs(H, W, T):
    """bf16 C 64 (the flagship: 2 granules of 16 bytes a quarter)."""
    B, C, esize = 2, 64, 2
    Y = layout(esize, C)
    L = H * W
    seen = np.zeros((B, L, 4, Y["NQ"]), np.int64)
    for q, (b, l, hh, ww, c0, k, valid) in tile_copies(B, H, W, C, esize, T).items():
        part = (c0 - q * Y["G"]) // Y["vec"]
        np.add.at(seen, (b[valid], l[valid], q, part[valid]), 1)
        # the source pixel's quarter-q sequence index is the position
        rm, cm = hh * W + ww, ww * H + hh
        idx = {0: rm, 1: L - 1 - rm, 2: cm, 3: L - 1 - cm}[q]
        assert (idx[valid] == l[valid]).all()
        assert ((hh >= 0) & (hh < H) & (ww >= 0) & (ww < W))[valid].all()
        # runs: copies NQ apart (the same granule of consecutive positions)
        # read consecutive pixels in raster order (0: forwards, 1:
        # backwards) or down the columns (2: forwards, 3: backwards), over
        # the ends of rows and columns too
        order = rm if q < 2 else cm
        step = 1 if q in (0, 2) else -1
        nq = Y["NQ"]
        both = valid[:, :-nq] & valid[:, nq:]
        d = (order[:, nq:] - order[:, :-nq])[both]
        assert (d == step).all()
    assert (seen == 1).all()


@pytest.mark.parametrize("H,W", MAPS, ids=[f"{a}x{b}" for a, b in MAPS])
def test_tiles_in_turn_from_both_ends_share_pixels(H, W):
    """Tiles 2 j and 2 j + 1 of an image are mirror images: where T divides
    L, quarter 1 of the second reads the pixels quarter 0 of the first
    reads (and 3 those of 2), so the two pieces of a 128-byte row are
    fetched together; otherwise the mirror is off by less than a tile."""
    C, esize, T = 64, 2, 128
    L = H * W
    tpi = -(-L // T)
    reads = tile_copies(1, H, W, C, esize, T)
    firsts = reads[0][1][:, 0]
    assert sorted(firsts) == [T * j for j in range(tpi)]
    for qa, qb in ((0, 1), (2, 3)):
        _, la, ha, wa, _, _, va = reads[qa]
        _, lb, hb, wb, _, _, vb = reads[qb]
        for j in range(0, tpi - 1, 2):
            pa = set(zip(ha[j][va[j]], wa[j][va[j]]))
            pb = set(zip(hb[j + 1][vb[j + 1]], wb[j + 1][vb[j + 1]]))
            shared = len(pa & pb) / len(pa)
            assert shared == 1.0 if L % T == 0 else shared > 0


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 16), (torch.bfloat16, 48),
                                     (torch.float32, 8), (torch.float32, 24)],
                         ids=["bf16_16", "bf16_48", "f32_8", "f32_24"])
@pytest.mark.parametrize("H,W", MAPS, ids=[f"{a}x{b}" for a, b in MAPS])
def test_tile_copies_equal_permute(H, W, dtype, C):
    """x gathered through the kernel's map is ``_permute(x)``, at the plan's
    tile (8-byte granules: bf16 C 16 and 48, float32 C 8 and 24; 3 a quarter
    at bf16 48 and f32 24)."""
    B, esize = 2, torch.finfo(dtype).bits // 8
    Y = layout(esize, C)
    T = cross_scan.gather_tile(dtype, C, B, H * W)
    x = torch.randn(B, H, W, C, generator=torch.Generator().manual_seed(H + W + C)).to(dtype)
    xs = x.view(torch.int16 if esize == 2 else torch.int32).numpy()
    seq = np.zeros((B, H * W, C), xs.dtype)
    for q, (b, l, hh, ww, c0, k, valid) in tile_copies(B, H, W, C, esize, T).items():
        b, l, hh, ww, c0 = (a[valid] for a in (b, l, hh, ww, c0))
        for e in range(Y["vec"]):
            seq[b, l, c0 + e] = xs[b, hh, ww, c0 + e]
    assert np.array_equal(seq, cross_scan._permute(x).view(
        torch.int16 if esize == 2 else torch.int32).numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_layout_covers_each_row_once_and_fits(dtype):
    """For every width the tile kernel takes: each row's granules are read
    by exactly one lane of its group (lanes past the row idle), a group
    lies inside one warp, the plan's T is a whole number of LayerNorm
    passes for every call size, and two buffers fit the block's shared
    memory; 16-byte granules at the flagship's widths."""
    esize = torch.finfo(dtype).bits // 8
    step = 32 // esize
    for C in range(step, 129, step):
        assert cross_scan.gather_path(dtype, C) == "tile"
        Y = layout(esize, C)
        assert Y["GB"] % 8 == 0 and Y["N"] % Y["M"] == 0 and Y["N"] // Y["M"] <= Y["P"] <= 32
        lanes = np.arange(Y["P"])
        chunks = [range(j * Y["M"], (j + 1) * Y["M"]) for j in lanes if j < Y["N"] // Y["M"]]
        assert sorted(g for ch in chunks for g in ch) == list(range(Y["N"]))
        assert (Y["LDS"] * esize) % Y["gran"] == 0  # staged rows keep granules aligned
        for bl in [(2, 25600), (8, 25600), (4, 518400), (4, 563200), (1, 391), (1, 1)]:
            T = cross_scan.gather_tile(dtype, C, *bl)
            assert T in (64, 128, 256) and T % Y["rows"] == 0
            assert 2 * T * Y["LDS"] * esize <= 227 * 1024
    assert layout(2, 64)["gran"] == layout(4, 64)["gran"] == 16
    assert layout(2, 64)["P"] == 8  # 8 threads a position, one 16-byte read each


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 64), (torch.bfloat16, 16),
                                     (torch.float32, 64), (torch.float32, 120)],
                         ids=["bf16_64", "bf16_16", "f32_64", "f32_120"])
def test_grouped_layer_norm_equals_the_twin(dtype, C):
    """LayerNorm of staged rows by the kernel's groups (each lane's chunk of
    M granules, the group's sums by xor-shuffle over P lanes, flax's fast
    variance, rounded once) equals ``cross_scan_gather_plain`` in float32
    within 1e-5 of scale."""
    esize = torch.finfo(dtype).bits // 8
    Y = layout(esize, C)
    g = torch.Generator().manual_seed(C)
    B, H, W = 2, 17, 23
    x = torch.randn(B, H, W, C, generator=g).to(dtype)
    gamma, beta = 1 + 0.2 * torch.randn(C, generator=g), 0.1 * torch.randn(C, generator=g)
    rows = cross_scan._permute(x).float().numpy().reshape(-1, C)
    chunk = Y["M"] * Y["vec"]
    lanes = rows.reshape(rows.shape[0], -1, chunk)  # [row, active lane, chunk]
    s1 = np.zeros((rows.shape[0], Y["P"]), np.float32)
    s2 = np.zeros_like(s1)
    s1[:, : lanes.shape[1]] = lanes.sum(-1)
    s2[:, : lanes.shape[1]] = (lanes * lanes).sum(-1)
    o = Y["P"] // 2
    while o:  # xor-shuffle butterfly: every lane ends with the group's sums
        s1 = s1 + s1[:, np.arange(Y["P"]) ^ o]
        s2 = s2 + s2[:, np.arange(Y["P"]) ^ o]
        o //= 2
    assert (s1 == s1[:, :1]).all()
    mean = s1[:, :1] / C
    inv = 1 / np.sqrt(np.maximum(s2[:, :1] / C - mean * mean, 0) + cross_scan.EPS)
    got = (rows - mean) * inv * gamma.numpy() + beta.numpy()
    want = cross_scan.cross_scan_gather_plain(x.float(), gamma, beta).numpy().reshape(-1, C)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# ---- the wrapper's launch plan, without a card --------------------------------

@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("dtype,C,B,H,W,path,T", [
    (torch.bfloat16, 64, 4, 720, 720, "tile", 128),   # Synth whole-scene
    (torch.bfloat16, 64, 4, 640, 880, "tile", 128),   # Real whole-scene
    (torch.bfloat16, 64, 8, 160, 160, "tile", 128),   # the batch-8 train step
    (torch.bfloat16, 64, 2, 160, 160, "tile", 64),    # tiled eval: a small call
    (torch.float32, 64, 4, 160, 160, "tile", 64),     # the float32 gradient check
    (torch.bfloat16, 16, 2, 40, 40, "tile", 64),      # the dryrun's width
    (torch.float32, 24, 1, 17, 23, "tile", 64),
    (torch.bfloat16, 4, 1, 17, 23, "warp", None),
    (torch.bfloat16, 12, 1, 17, 23, "warp", None),
    (torch.float32, 20, 1, 17, 23, "warp", None),
])
def test_k4_launch_by_dtype_and_width(launches, dtype, C, B, H, W, path, T):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(B, H, W, C, generator=g).to(dtype)
    before = trace.counts("launches/K4/")
    n = trace.counter("launches/K4")
    cross_scan.cross_scan_gather(x, torch.ones(C), torch.zeros(C))
    ((name, a),) = launches
    assert cross_scan.gather_path(dtype, C) == path
    assert trace.counts("launches/K4/") == {k: v + (k == path) for k, v in before.items()}
    assert trace.counter("launches/K4") == n + 1
    if path == "tile":
        assert name == "lfsr_cross_scan_gather_tile"
        assert a[4:9] == (B, H, W, C, T) and a[-2] == _cuda.DTYPE_CODES[dtype]
        assert T == cross_scan.gather_tile(dtype, C, B, H * W)
    else:
        assert name == "lfsr_cross_scan_gather"
        assert a[4:8] == (B, H, W, C) and a[-2] == _cuda.DTYPE_CODES[dtype]

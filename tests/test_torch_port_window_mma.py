"""K6's tensor-core path on the CPU: its numerics, its choice and its plan.

The tensor-core kernel (csrc/window_attention.cu, ``"mma"``) runs every
product of the window block as ``mma.sync`` m16n8k16 in bf16x3: each
operand is split into hi = bf16(a) and lo = bf16(a - hi) (round to nearest
even, as ``__floats2bfloat162_rn``) and the k-steps of 16 add lo.hi + hi.lo
+ hi.hi into float32 sums (16 of float32's 24 mantissa bits). 3xTF32 on
m16n8k8 (hi = a cut to TF32, lo = a - hi as the tensor core reads it) was
measured beside it and is slower (PERF.md section 6). The kernel runs only
on the card; here both products are emulated in numpy and run through K6's
math (LayerNorm, qkv, 4 heads of 16 over 64-token windows, softmax,
out-proj, scaled residual) at [2, 16, 16, 64]. Each must hold
``window_mha_plain`` and JAX's ``window_mha_fused`` (Pallas, interpret
mode) to 1e-4 of the output's scale, the bound chip_smoke.py holds the
kernel to in float32, with a factor of 10 to spare. The same math with
plain TF32 products (one rounding of each operand, to nearest) misses that
bound at attn_scale 1.0, which is why a split is needed; at the seeded
init's 0.25 the attention branch is a quarter of the output and plain TF32
lands at ~5e-5, inside it.

Also: which kernel ``kernel_path`` picks by shape (the flagship's head dim
16 on the tensor cores; the dryrun's 4 and the 72-wide V8 geometry's 18 on
the CUDA cores) and which entry each call reaches, and the persistent plan
(CTAs, windows a CTA, shared-memory bytes) against its arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.ops import pallas_attention as jpa
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import _cuda, window_attention as wa

f32 = np.float32
WS, HEADS, T = 8, 4, 64


def _bits(a):
    return np.ascontiguousarray(a, dtype=f32).view(np.uint32).astype(np.uint64)


def tf32(a):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((_bits(a) + 0x1000) & 0xFFFFE000).astype(np.uint32).view(f32)


def tf32_cut(a):
    """float32 cut to TF32: its low 13 bits cleared."""
    return (_bits(a) & 0xFFFFE000).astype(np.uint32).view(f32)


def bf16(a):
    """float32 rounded to bfloat16 (7 mantissa bits), to nearest even."""
    b = _bits(a)
    return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(f32)


# product -> (k-step, split of an operand into the parts it sums)
PRODUCTS = {
    "bf16x3": (16, lambda a: (bf16(a), bf16(a - bf16(a)))),
    "tf32x3": (8, lambda a: (tf32_cut(a), tf32_cut(a - tf32_cut(a)))),
    "tf32": (8, lambda a: (tf32(a), None)),
}


def mm_emulated(a, b, product: str):
    """a @ b over the last two axes as the kernel sums it: k-steps of 8 or
    16, each adding lo.hi, hi.lo, hi.hi (a split product) or hi.hi (plain
    TF32) into a float32 accumulator."""
    step, split = PRODUCTS[product]
    (ah, al), (bh, bl) = split(a.astype(f32)), split(b.astype(f32))
    terms = [(ah, bh)] if al is None else [(al, bh), (ah, bl), (ah, bh)]
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], f32)
    for k in range(0, a.shape[-1], step):
        s = slice(k, k + step)
        for p, q in terms:
            acc = (acc + np.matmul(p[..., s], q[..., s, :])).astype(f32)
    return acc


def k6_emulated(x, wqkv, wout, g, b, bias, sc, product: str, eps=1e-6):
    """K6's function in float32 with every product emulated."""
    B, H, W, C = x.shape
    hd = C // HEADS
    xw = x.reshape(B, H // WS, WS, W // WS, WS, C).transpose(0, 1, 3, 2, 4, 5).reshape(-1, T, C)
    mu = xw.mean(-1, keepdims=True, dtype=f32)
    xc = xw - mu
    inv = (1 / np.sqrt((xc * xc).mean(-1, keepdims=True, dtype=f32) + f32(eps))).astype(f32)
    ln = (xc * inv * g + b).astype(f32)
    qkv = mm_emulated(ln, wqkv, product)
    heads = lambda a: a.reshape(-1, T, HEADS, hd).transpose(0, 2, 1, 3)
    q = heads(qkv[..., :C] * f32(1 / hd**0.5))
    k, v = heads(qkv[..., C : 2 * C]), heads(qkv[..., 2 * C :])
    s = mm_emulated(q, k.transpose(0, 1, 3, 2), product)
    s = s + bias.reshape(T, HEADS, T).transpose(1, 0, 2)
    e = np.exp(s - s.max(-1, keepdims=True)).astype(f32)
    p = (e * (1 / e.sum(-1, keepdims=True, dtype=f32))).astype(f32)
    o = mm_emulated(p, v, product).transpose(0, 2, 1, 3).reshape(-1, T, C)
    out = mm_emulated(o, wout, product) * f32(sc)
    out = out.reshape(B, H // WS, W // WS, WS, WS, C).transpose(0, 1, 3, 2, 4, 5)
    return (x + out.reshape(B, H, W, C)).astype(f32)


def _operands(seed, C=64):
    rng = np.random.default_rng(seed)
    rn = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(f32)
    return (rn(2, 16, 16, C), rn(C, 3 * C, sc=C**-0.5), rn(C, C, sc=C**-0.5),
            1 + rn(C, sc=0.2), rn(C, sc=0.1), rn(T, HEADS * T, sc=0.02))


@pytest.mark.parametrize("attn_scale", [0.25, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_products_hold_the_float32_bound_and_plain_tf32_does_not(seed, attn_scale):
    x, wqkv, wout, g, b, bias = _operands(seed)
    sc = np.full((1,), attn_scale, f32)
    t = lambda *a: [torch.from_numpy(v) for v in a]
    plain = wa.window_mha_plain(*t(x, wqkv, wout, g, b, bias, sc), WS, HEADS, 1e-6).numpy()
    jax_y = np.asarray(jpa.window_mha_fused(*map(jnp.asarray, (x, wqkv, wout, g, b, bias)),
                                            jnp.asarray(attn_scale), WS, HEADS, 1e-6))
    got = {p: k6_emulated(x, wqkv, wout, g, b, bias, attn_scale, p) for p in PRODUCTS}
    for want in (plain, jax_y):
        scale = max(1.0, float(np.abs(want).max()))
        err = {p: float(np.abs(y - want).max()) for p, y in got.items()}
        assert err["bf16x3"] <= 1e-4 * scale / 10, (err, scale)  # 10x inside the bound
        assert err["tf32x3"] <= 1e-4 * scale / 10, (err, scale)
        if attn_scale == 1.0:
            assert err["tf32"] > 1e-4 * scale, (err, scale)  # plain TF32 misses it


def test_operand_splits_keep_their_bits():
    a = np.array([1 + 2**-10, 1 + 2**-11, 1 + 2**-11 + 2**-12, -(1 + 3 * 2**-11)], f32)
    np.testing.assert_array_equal(tf32(a), np.array([1 + 2**-10, 1 + 2**-10, 1 + 2**-10,
                                                     -(1 + 2 * 2**-10)], f32))
    np.testing.assert_array_equal(tf32_cut(a), np.array([1 + 2**-10, 1, 1, -(1 + 2**-10)], f32))
    np.testing.assert_array_equal(bf16(np.array([1 + 2**-8, 1 + 3 * 2**-8], f32)),
                                  np.array([1, 1 + 2**-6], f32))  # ties to even
    r = np.random.default_rng(0).standard_normal(1000).astype(f32)
    for product, bits in (("bf16x3", 16), ("tf32x3", 20)):
        hi, lo = PRODUCTS[product][1](r)
        assert np.all(np.abs(r - hi - lo) <= np.abs(r) * 2.0**-bits), product


@pytest.mark.parametrize("C,heads,ws,path", [
    (64, 4, 8, "mma"),   # the flagship: head dim 16
    (32, 4, 8, "mma"),   # head dim 8
    (88, 1, 8, "mma"),   # the widest plan that fits a CTA
    (16, 4, 8, "fma"),   # the dryrun: head dim 4
    (72, 4, 8, "fma"),   # the 72-wide V8 geometry: head dim 18
    (64, 4, 4, "fma"),   # 16-token windows
    (96, 4, 8, "fma"),   # wider than the tensor-core plan
])
def test_kernel_path_by_shape(C, heads, ws, path):
    assert wa.kernel_path(C, heads, ws) == path


@pytest.fixture
def launches(monkeypatch):
    """The wrapper takes its kernel path on CPU tensors and every launch is
    recorded as (entry point, args) instead of run."""
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "sm_count", lambda t: 132)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,heads,path", [(64, 4, "mma"), (16, 4, "fma"), (72, 4, "fma")])
def test_each_call_reaches_its_kernel_and_is_counted(launches, dtype, C, heads, path):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 24, C, generator=g).to(dtype)
    args = (torch.randn(C, 3 * C, generator=g), torch.randn(C, C, generator=g), torch.ones(C),
            torch.zeros(C), torch.randn(T, heads * T, generator=g), torch.full((1,), 0.25))
    before, calls = trace.counts("launches/K6/"), trace.counter("launches/K6")
    with torch.no_grad():
        y = wa.window_mha_fused(x, *args, WS, heads, 1e-6)
    ((name, a),) = launches
    assert name == {"mma": "lfsr_window_mha_mma", "fma": "lfsr_window_mha"}[path]
    assert a[7] == y.data_ptr() and a[8:12] == (2, 16, 24, C)
    tail = a[12:] if path == "mma" else a[13:]  # the CUDA-core entry also takes ws
    assert tail[0] == heads and tail[1] == pytest.approx((C // heads) ** -0.5)
    if path == "mma":  # the persistent plan: CTAs, windows a CTA, shared-memory bytes
        assert tail[3:6] == wa.mma_plan(2, 16, 24, C, x.element_size(), 132)
        tail = tail[3:]
    assert tail[3] == _cuda.DTYPE_CODES[dtype]
    assert trace.counts("launches/K6/")[path] == before[path] + 1
    assert sum(trace.counts("launches/K6/").values()) == sum(before.values()) + 1
    assert trace.counter("launches/K6") == calls + 1


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("C", [16, 32, 64, 72, 88])
def test_persistent_plan_against_its_arithmetic(C, itemsize):
    """Bytes: fragment-ordered Wqkv and Wout (16 C^2), gamma and beta (8 C),
    and per window an x buffer, K and V of 64 rows at their padded strides;
    as many windows a CTA as fit 227 KB, up to 2; at most one CTA an SM, and
    the CTAs' windows cover the map's."""
    words = lambda w, r, m: w + (r - w) % m
    ldx = words(C * itemsize // 4, 8, 16) if itemsize == 4 else words(C * itemsize // 4, 4, 8)
    ldk, ldv = words(C // 2, 4, 16), words(C, 4, 16)  # in 8-byte (hi, lo) entries
    assert ldk % 16 == 4 and ldv % 16 == 4 and ldx % 4 == 0  # conflict-free, 16-byte rows
    # Wqkv and Wout: 3 C/8 + C/8 column tiles x ceil(C/16) 16-row steps x 32 lanes x 16 bytes
    weights = 4 * (C // 8) * (-(-C // 16)) * 32 * 16
    assert C % 16 or weights == 16 * C * C  # the float32 weights' bytes when C % 16 == 0
    per_window = 64 * 4 * ldx + 64 * 8 * ldk + 32 * 8 * ldv
    for w in (1, 2):
        assert wa.mma_smem_bytes(C, itemsize, w) == weights + 8 * C + w * per_window
    fits = max(w for w in (1, 2)
               if weights + 8 * C + w * per_window <= 227 * 1024)
    for B, H, W in ((4, 720, 720), (2, 160, 160), (1, 8, 16)):
        ctas, per_cta, smem = wa.mma_plan(B, H, W, C, itemsize, 132)
        windows = B * (H // 8) * (W // 8)
        assert per_cta == fits
        assert smem == wa.mma_smem_bytes(C, itemsize, per_cta) <= 227 * 1024
        assert ctas == min(132, -(-windows // per_cta)) and ctas * per_cta >= min(windows, 132)


def test_flagship_plan_holds_two_windows_a_cta():
    """[4, 720, 720, 64] float32 (the Synth dispatch): 32,400 windows on 132
    CTAs of 2 windows (8 warps, 174,592 bytes), ~123 windows a group."""
    assert wa.mma_plan(4, 720, 720, 64, 4, 132) == (132, 2, 174592)
    assert wa.mma_plan(4, 720, 720, 64, 2, 132) == (132, 2, 156160)
    assert wa.mma_plan(2, 160, 160, 64, 4, 132) == (132, 2, 174592)

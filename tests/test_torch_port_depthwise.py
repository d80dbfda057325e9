"""K11 — the depthwise convs outside the blocks — without a card.

The plain twin (``ops.depthwise.depthwise_plain``, what the wrapper runs on
a CPU tensor) against JAX: ``_dw_apply`` bit for bit in bfloat16 (3x3 at
dilation 1 and 3), and LSFL's (1, 3) / (3, 1) dilation-5 grouped convs
against flax's grouped ``Conv`` within a stated tolerance. The bias is
added in the dtype, as ``Conv.forward`` adds it. With a gradient wanted
the wrapper launches the kernel forward and gives the plain chain's
gradient (``_cuda.PlainVJP``), equal to the gradient of the code before
K11. Every depthwise conv LFMambaX builds is taken (any C, any dilation:
channel blocks and a run-time row dilation), and ``Conv`` refuses one the
kernel does not take when it is built. The kernel's plan (channel block,
tile, shared memory, launch arguments) is read with ``_cuda``'s launch
replaced by a recorder, and a numpy model of the kernel's staged tiles
(zero-filled halo and channels, tap offsets, ragged edges, channel blocks)
is held to the twin bit for bit. The official MACs of the flagship are
unchanged. The kernel itself runs on the card
(tests/test_torch_port_depthwise_cuda.py).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.models import common as jcommon
from lfsr_tpu.models import lfmambax as jlfm
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models import common
from lfsr_tpu_torch.models.lfmambax import LFMambaX
from lfsr_tpu_torch.ops import _cuda, depthwise as dw

# flax's bf16 grouped conv on the CPU and torch's round the float32 sum once
# each, in their own order: within 2 bf16 ulps of the output's scale
ONCE_BF16_TOL = 2.0**-7
ONCE_F32_TOL = 1e-5


def _rn(shape, seed, s=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * s


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


class _JaxDW(fnn.Module):
    feats: int
    dilation: int

    @fnn.compact
    def __call__(self, x):
        return jlfm._dw_apply(x, self.feats, jnp.bfloat16, 3, self.dilation)


class _JaxEPI(fnn.Module):
    feats: int
    kernel: tuple
    dilation: tuple
    dtype: object

    @fnn.compact
    def __call__(self, x):
        pad = tuple(d * (k - 1) // 2 for k, d in zip(self.kernel, self.dilation))
        return jcommon.conv(self.feats, self.kernel, dilation=self.dilation, padding=pad,
                            groups=self.feats, use_bias=False, dtype=self.dtype)(x)


def _jax_apply(module, w_port: np.ndarray, x: np.ndarray):
    """Run ``module`` with its one conv's kernel set to the port's weight
    [C, 1, kh, kw] (flax HWIO: [kh, kw, 1, C])."""
    params = module.init(jax.random.key(0), jnp.asarray(x))
    name = next(iter(params["params"]))
    kernel = jnp.asarray(w_port.transpose(2, 3, 1, 0))
    return np.asarray(module.apply({"params": {name: {"kernel": kernel}}}, jnp.asarray(x)),
                      np.float32)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("shape", [(2, 24, 40, 16), (1, 13, 7, 8)])
def test_plain_twin_equals_jax_dw_apply_bit_for_bit(d, shape):
    C = shape[-1]
    x, w = _rn(shape, 1), _rn((C, 1, 3, 3), 2, 0.3)
    want = _jax_apply(_JaxDW(C, d), w, jnp.asarray(x, jnp.bfloat16))
    got = dw.depthwise_conv(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), d, "tap")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(torch.from_numpy(want).bfloat16()))


@pytest.mark.parametrize("kernel,dilation", [((1, 3), (1, 5)), ((3, 1), (5, 1))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lsfl_epi_convs_agree_with_flax_grouped_conv(kernel, dilation, dtype):
    C, dt = 16, getattr(torch, dtype)
    x, w = _rn((2, 30, 35, C), 3), _rn((C, 1, *kernel), 4, 0.4)
    conv = common.Conv(C, C, kernel, dilation=dilation,
                       padding=dw.same_padding(kernel, dilation), groups=C, bias=False, dtype=dt)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        got = conv(torch.from_numpy(x)).float().numpy()
    want = _jax_apply(_JaxEPI(C, kernel, dilation, getattr(jnp, dtype)), w, x)
    tol = ONCE_BF16_TOL if dtype == "bfloat16" else ONCE_F32_TOL
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("rounding,kernel,d", [("tap", (3, 3), 1), ("tap", (3, 3), 3),
                                               ("once", (1, 3), (1, 5)), ("once", (3, 1), (5, 1))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_bias_is_added_in_the_dtype(rounding, kernel, d, dtype):
    x = torch.from_numpy(_rn((2, 11, 17, 24), 5)).to(dtype)
    w, b = torch.from_numpy(_rn((24, 1, *kernel), 6, 0.3)), torch.from_numpy(_rn((24,), 7))
    got = dw.depthwise_conv(x, w, d, rounding, b)
    want = dw.depthwise_conv(x, w, d, rounding) + b.to(dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.fixture
def launches(monkeypatch):
    """The wrapper takes its kernel path on CPU tensors and each launch is
    recorded as (entry point, args) instead of run."""
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


def _counts():
    return trace.counts("launches/K11")


def _old_dw_apply(conv, x, dt):
    """``dw_apply`` as it read before K11: the chain written out."""
    k, d = conv.weight.shape[-1], conv.dilation[0]
    wk = conv.weight[:, 0].permute(1, 2, 0).to(dt)
    pad = d * (k - 1) // 2
    xp = torch.nn.functional.pad(x.to(dt), (0, 0, pad, pad, pad, pad))
    H, W = x.shape[1], x.shape[2]
    out = None
    for ky in range(k):
        for kx in range(k):
            term = xp[:, ky * d : ky * d + H, kx * d : kx * d + W, :] * wk[ky, kx]
            out = term if out is None else out + term
    return out


def _old_conv(conv, x, dt):
    """``Conv.forward`` as it read before K11 (a grouped conv's branch)."""
    y = torch.nn.functional.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), None,
                                   padding=conv.padding, dilation=conv.dilation,
                                   groups=conv.groups).permute(0, 2, 3, 1)
    return y + conv.bias.to(dt)


def _grad_site(site):
    """A depthwise site with seeded parameters that require grad, its input,
    the call of the port, and the code before K11."""
    C = 16
    x = torch.from_numpy(_rn((2, 12, 14, C), 8)).bfloat16()
    if site == "dw_apply":
        conv = common.Conv(C, C, 3, dilation=3, padding=3, groups=C, bias=False,
                           dtype=torch.bfloat16)
        run = lambda: common.dw_apply(conv, x, torch.bfloat16)
        chain = lambda: _old_dw_apply(conv, x, torch.bfloat16)
    else:
        conv = common.Conv(C, C, (1, 3), dilation=(1, 5), padding=(0, 5), groups=C,
                           dtype=torch.bfloat16)
        run = lambda: conv(x)
        chain = lambda: _old_conv(conv, x, torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(_rn(tuple(conv.weight.shape), 9, 0.3)))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(_rn((C,), 10)))
    return conv, x, run, chain


@pytest.mark.parametrize("site", ["dw_apply", "conv"])
def test_a_wanted_gradient_takes_the_plain_chain(launches, site):
    """Parameters that require grad, under enable_grad: the kernel is
    launched once (through PlainVJP) and the gradient is the chain's, that
    of the code before K11 bit for bit. The loss is linear in the output,
    so the recorder's unwritten output does not reach the gradient."""
    conv, x, run, chain = _grad_site(site)
    g = torch.from_numpy(_rn((2, 12, 14, 16), 11))
    before = _counts()
    with torch.enable_grad():
        grads = torch.autograd.grad((run().float() * g).sum(), list(conv.parameters()))
        want = torch.autograd.grad((chain().float() * g).sum(), list(conv.parameters()))
    after = _counts()
    assert [n for n, _ in launches] == ["lfsr_depthwise"]
    rounding = "tap" if site == "dw_apply" else "once"
    assert {k: after[k] - before[k] for k in after} == {
        "": 1, "/tap": rounding == "tap", "/once": rounding == "once"}
    for got, ref in zip(grads, want):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("site", ["dw_apply", "conv"])
def test_a_wanted_gradient_on_the_cpu_is_the_chains(site):
    """On a CPU tensor the same path runs the twin forward: the output and
    the gradients (weight, bias and input) of the code before K11, bit for
    bit."""
    conv, x, run, chain = _grad_site(site)
    x.requires_grad_(True)
    with torch.enable_grad():
        y, y0 = run(), chain()
        wrt = [x, *conv.parameters()]
        grads = torch.autograd.grad(y.float().square().sum(), wrt)
        want = torch.autograd.grad(y0.float().square().sum(), wrt)
    np.testing.assert_array_equal(_bits(y.detach()), _bits(y0.detach()))
    for got, ref in zip(grads, want):
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("rounding,kernel,d,C,bias", [
    ("tap", (3, 3), 1, 64, False), ("tap", (3, 3), 3, 64, False), ("tap", (3, 3), 2, 20, False),
    ("once", (1, 3), (1, 5), 64, False), ("once", (3, 1), (5, 1), 64, True),
    ("once", (3, 1), (7, 1), 30, True), ("tap", (3, 3), 1, 4096, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_wrapper_launches_one_kernel_with_its_plan(launches, rounding, kernel, d, C, bias,
                                                       dtype):
    """Without a gradient: one launch of lfsr_depthwise, counted under its
    rounding, with the plan's channel block and tile."""
    B, H, W = 2, 37, 53
    x = torch.zeros(B, H, W, C, dtype=dtype)
    w = torch.zeros(C, 1, *kernel)
    b = torch.zeros(C) if bias else None
    before = _counts()
    with torch.no_grad():
        y = dw.depthwise_conv(x, w, d, rounding, b)
    after = _counts()
    assert y.shape == x.shape and y.dtype == dtype
    assert [n for n, _ in launches] == ["lfsr_depthwise"]
    args = launches[0][1]
    dh, dwd = dw._pair(d)
    cs = dw.channel_block(C, x.element_size(), kernel, (dh, dwd))
    tile = dw.tile_plan(cs, x.element_size(), kernel, (dh, dwd))
    assert (args[2] is not None) == bias
    assert args[4:] == (B, H, W, C, *kernel, dh, dwd, cs, *tile, dw.ROUNDINGS.index(rounding),
                        _cuda.DTYPE_CODES[dtype], 0)
    assert {k: after[k] - before[k] for k in after} == {
        "": 1, "/tap": rounding == "tap", "/once": rounding == "once"}


@pytest.mark.parametrize("C,kernel,d", [(64, (5, 5), 1), (64, (3, 3), 0), (64, (1, 1), 1),
                                         (8, (3, 3), 400)])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(launches, C, kernel, d):
    with torch.no_grad(), pytest.raises(ValueError):
        dw.depthwise_conv(torch.zeros(1, 8, 8, C), torch.zeros(C, 1, *kernel), d, "tap")
    assert launches == []


@pytest.mark.parametrize("kernel,dilation,padding", [(5, 1, 2), (3, 1, 0), (3, 2, 1),
                                                     ((1, 3), (1, 5), (0, 4))])
def test_conv_refuses_a_depthwise_conv_the_kernel_does_not_take(kernel, dilation, padding):
    with pytest.raises(ValueError, match="K11 takes"):
        common.Conv(16, 16, kernel, dilation=dilation, padding=padding, groups=16)
    # the same shapes as ordinary convs are no business of K11's
    common.Conv(16, 16, kernel, dilation=dilation, padding=padding)


@pytest.mark.parametrize("channels,ang", [(20, 5), (24, 3), (40, 7), (64, 9)])
def test_the_kernel_takes_every_depthwise_conv_lfmambax_builds(launches, channels, ang):
    """Every depthwise conv of LFMambaX at channel counts K7 declines and at
    other angular resolutions (LSFL's row dilation) launches K11."""
    model = LFMambaX(Config(angRes=ang, model_kwargs={"channels": channels}))
    convs = [m for m in model.modules() if isinstance(m, common.Conv) and m.depthwise]
    assert len(convs) >= 13
    for m in convs:
        c = m.weight.shape[0]
        with torch.no_grad():
            m(torch.zeros(1, 9, 11, c, dtype=torch.bfloat16))
            common.dw_apply(m, torch.zeros(1, 9, 11, c), torch.bfloat16)
    assert [n for n, _ in launches] == ["lfsr_depthwise"] * (2 * len(convs))


@pytest.mark.parametrize("C", [1, 18, 20, 30, 64, 2048, 2056, 4096, 5000])
@pytest.mark.parametrize("kernel,d", [((3, 3), (1, 1)), ((3, 3), (3, 3)), ((3, 1), (9, 1))])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_the_channel_blocks_are_the_fewest_equal_ones_that_fit(C, kernel, d, itemsize):
    cs = dw.channel_block(C, itemsize, kernel, d)
    n = -(-C // cs)
    assert cs % dw.GROUP == 0 and cs <= dw.MAX_BLOCK and (n - 1) * cs < C
    assert dw._plans(cs, itemsize, kernel, d)
    if n == 1:
        assert cs == -(-C // dw.GROUP) * dw.GROUP
    else:  # one block fewer does not fit
        fewer = -(-(-(-C // dw.GROUP) * dw.GROUP // (n - 1)) // dw.GROUP) * dw.GROUP
        assert fewer > dw.MAX_BLOCK or not dw._plans(fewer, itemsize, kernel, d)


# the flagship's sites: (kernel, dilation) of each, and the compute dtypes
SITES = [((3, 3), (1, 1)), ((3, 3), (3, 3)), ((1, 3), (1, 5)), ((3, 1), (5, 1))]


@pytest.mark.parametrize("kernel,d", SITES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_the_plan_fits_its_staged_tiles_and_ranks_them(kernel, d, itemsize):
    """The plan's staged tiles fit a CTA; no plan puts more CTAs on an SM,
    nor as many with wider tiles, nor as many as wide with more tiles
    staged, nor as many, as wide and as staged with taller tiles."""
    assert dw.channel_block(64, itemsize, kernel, d) == 64
    th, tw, stages = dw.tile_plan(64, itemsize, kernel, d)
    smem = dw.smem_bytes((th, tw), 64, itemsize, kernel, d, stages)
    assert smem <= dw.SMEM_BYTES and th % dw.RUN == 0 and stages in (1, 2)
    ctas = dw.ctas_per_sm(smem)
    for t, n in dw._plans(64, itemsize, kernel, d):
        other = (dw.ctas_per_sm(dw.smem_bytes(t, 64, itemsize, kernel, d, n)), t[1], n, t[0])
        assert other <= (ctas, tw, stages, th)


@pytest.mark.parametrize("kernel,d,plan", [((3, 3), (1, 1), (8, 32, 2)),
                                           ((3, 3), (3, 3), (16, 32, 1)),
                                           ((1, 3), (1, 5), (8, 32, 2)),
                                           ((3, 1), (5, 1), (16, 32, 1))])
def test_the_flagship_bf16_sites_get_two_ctas_an_sm(kernel, d, plan):
    assert dw.tile_plan(64, 2, kernel, d) == plan
    assert dw.ctas_per_sm(dw.smem_bytes(plan[:2], 64, 2, kernel, d, plan[2])) == 2


def _kernel_model(x: torch.Tensor, w: torch.Tensor, d, rounding: str, tile, cs) -> torch.Tensor:
    """csrc/depthwise.cu's addressing: each tile of cs channels from c0 has
    its input and halo staged as [SH, SW, cs] with zeros outside the image
    and past C, its taps likewise; an item (a column px and a run of RUN
    rows from seg RUN) reads staged row r of its column once, its KW taps
    at r rs + kx cs past the item's origin, and gives each output i = r -
    ky dh of the run its taps, so each output's arrive in (ky, kx) order
    (the order in which an output reads its rows itself at a run-time row
    dilation); rows, columns and channels past the map are not stored."""
    B, H, W, C = x.shape
    kh, kw = w.shape[-2:]
    (dh, dwd), (th, tw) = dw._pair(d), tile
    ph, pw = dw.same_padding((kh, kw), (dh, dwd))
    SH, SW = th + (kh - 1) * dh, tw + (kw - 1) * dwd
    rs, cstep = SW * cs, dwd * cs
    dt = x.dtype
    wk = torch.zeros(kh * kw, -(-C // cs) * cs, dtype=dt)
    wk[:, :C] = w[:, 0].reshape(C, kh * kw).t().to(dt)  # [KK, channels], zeros past C
    y = torch.full_like(x, float("nan"))
    for b in range(B):
        for c0 in range(0, C, cs):
            n = min(cs, C - c0)
            for y0 in range(0, H, th):
                for x0 in range(0, W, tw):
                    st = torch.zeros(SH * SW, cs, dtype=dt)
                    for sy in range(SH):
                        for sx in range(SW):
                            gy, gx = y0 - ph + sy, x0 - pw + sx
                            if 0 <= gy < H and 0 <= gx < W:
                                st[sy * SW + sx, :n] = x[b, gy, gx, c0 : c0 + n]
                    flat = st.reshape(-1)
                    for it in range(tw * (th // dw.RUN)):
                        seg, px = divmod(it, tw)
                        origin = (seg * dw.RUN * SW + px) * cs
                        acc = [None] * dw.RUN
                        for r in range(dw.RUN + (kh - 1) * dh):
                            at = [origin + r * rs + kx * cstep for kx in range(kw)]
                            v = [flat[a : a + cs] for a in at]
                            for ky in range(kh):
                                i = r - ky * dh
                                if not 0 <= i < dw.RUN:
                                    continue
                                for kx in range(kw):
                                    tap = wk[ky * kw + kx, c0 : c0 + cs]
                                    if rounding == "tap":
                                        t = v[kx] * tap
                                    else:
                                        t = v[kx].float() * tap.float()
                                    acc[i] = t if acc[i] is None else acc[i] + t
                        for i in range(dw.RUN):
                            gy, gx = y0 + seg * dw.RUN + i, x0 + px
                            if gy < H and gx < W:
                                y[b, gy, gx, c0 : c0 + n] = acc[i][:n].to(dt)
    return y


@pytest.mark.parametrize("kernel,d,tile,C,cs", [
    ((3, 3), 1, (8, 8), 8, 8), ((3, 3), 3, (16, 8), 8, 8), ((1, 3), (1, 5), (8, 16), 8, 8),
    ((3, 1), (5, 1), (8, 8), 8, 8), ((3, 3), 2, (8, 8), 20, 8), ((3, 1), (7, 1), (8, 16), 12, 16)])
def test_the_kernels_staged_tiles_give_the_twin_bit_for_bit(kernel, d, tile, C, cs):
    x = torch.from_numpy(_rn((1, 19, 21, C), 11)).bfloat16()
    w = torch.from_numpy(_rn((C, 1, *kernel), 12, 0.3))
    rounding = "tap" if kernel == (3, 3) else "once"
    got = _kernel_model(x, w, d, rounding, tile, cs)
    want = dw.depthwise_conv(x, w, d, rounding)
    if rounding == "tap":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:  # float32 sums in (ky, kx) order against the CPU conv's: within an ulp
        assert (got.float() - want.float()).abs().max() <= 2**-8 * want.float().abs().max()


def test_official_macs_of_the_flagship_are_unchanged():
    from lfsr_tpu_torch.tools.efficiency import official_macs

    assert official_macs(Config())[0] == 18_118_185_344

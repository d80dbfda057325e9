"""K11 (csrc/depthwise.cu) on the card against its plain twin.

``"tap"`` bit for bit equal to ``dw_apply``'s chain at every main-path map
(the Synth and Real whole-scene LR maps, HLFR's last stage at twice their
side, the tiled patch) and at a ragged one, at dilations 1, 3 and 5 and at
2 (the run-time row dilation), in bfloat16 and float32; ``"once"`` within 1
bf16 ulp of ``F.conv2d`` (cuDNN sums in its own order) at LSFL's two EPI
convs, at a run-time row dilation and in float32 within 1e-5 of the
output's scale; the bias against the twin's; any channel count (a ragged
last group of channels, channel blocks). One flagship eval forward with
K11 equals the same forward with K11 swapped for its twin bit for bit;
``launches/K11`` counts 13 a forward (11 "tap", 2 "once"). A train forward
launches K11 13 times and its gradients are those of the same step with
the twins forward.

This file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_depthwise_cuda.py

Here (no CUDA device) every test skips.
"""

import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.ops import depthwise as dw

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

# the flagship's maps: LR mosaics of a whole-scene dispatch (Synth, Real),
# HLFR's last stage at twice their side, the tiled patch, a ragged map
SHAPES = [(4, 720, 720, 64), (4, 640, 880, 64), (4, 1440, 1440, 64), (4, 1280, 1760, 64),
          (2, 160, 160, 64), (1, 37, 53, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rn(g, *shape, s=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=g, device="cuda") * s).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _plain(*args, **kw):
    return dw.depthwise_plain(*args, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k11_tap_equals_the_chain_bit_for_bit(cuda, shape, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(d)
    x = _rn(g, *shape, dtype=dtype)
    w = _rn(g, shape[-1], 1, 3, 3, s=0.3)
    with torch.no_grad():
        got = dw.depthwise_conv(x, w, d, "tap")
        want = _plain(x, w, d, "tap")
    assert torch.equal(_bits(got), _bits(want))


def _ulp(v, dtype):
    """One ulp of the dtype at |v| (frexp: |v| = m 2^e, m in [0.5, 1))."""
    return torch.ldexp(torch.ones_like(v),
                       torch.frexp(v.abs()).exponent - (8 if dtype == torch.bfloat16 else 24))


def _slack(x, w, d):
    """The float32 sums' own rounding in another order on each side: (KK -
    1) 2^-23 of the sum of |x w| (KK - 1 adds a side, each within 2^-24 of
    it)."""
    kk = w.shape[-2] * w.shape[-1]
    return (kk - 1) * 2.0**-23 * dw.depthwise_plain(x.abs(), w.abs(), d, "once").float()


def _within_an_ulp(got, want, x, w, d) -> bool:
    """|got - want| <= one ulp of the dtype at the larger of the two, plus
    the float32 sums' own rounding (:func:`_slack`)."""
    got, want = got.float(), want.float()
    bound = _ulp(torch.maximum(got.abs(), want.abs()), x.dtype) + _slack(x, w, d)
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[4:], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel,d", [((1, 3), (1, 5)), ((3, 1), (5, 1)), ((3, 3), (3, 3)),
                                      ((3, 1), (7, 1))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k11_once_is_within_an_ulp_of_conv2d(cuda, shape, kernel, d, dtype):
    """One rounding each of float32 sums in two orders: within one ulp of
    the dtype, plus what the float32 sums themselves round by."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = _rn(g, *shape, dtype=dtype)
    w = _rn(g, shape[-1], 1, *kernel, s=0.4)
    with torch.no_grad():
        got = dw.depthwise_conv(x, w, d, "once")
        want = _plain(x, w, d, "once")
        assert _within_an_ulp(got, want, x, w, d)


@pytest.mark.parametrize("rounding,kernel,d", [("tap", (3, 3), 1), ("tap", (3, 3), 3),
                                               ("once", (1, 3), (1, 5)), ("once", (3, 1), (5, 1))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k11_bias_is_the_twins(cuda, rounding, kernel, d, dtype):
    """The bias against the plain twin's (the conv, then + bias.to(dt)):
    "tap" bit for bit; "once" within the conv's bound (an ulp of the conv
    plus the sums' slack) and one more ulp of the output for the add's
    rounding."""
    g = torch.Generator(device="cuda").manual_seed(9)
    x, w = _rn(g, 4, 640, 880, 64, dtype=dtype), _rn(g, 64, 1, *kernel, s=0.4)
    b = _rn(g, 64, s=0.1)
    with torch.no_grad():
        got = dw.depthwise_conv(x, w, d, rounding, b)
        want = _plain(x, w, d, rounding, b)
        if rounding == "tap":
            assert torch.equal(_bits(got), _bits(want))
            return
        conv, ref = (dw.depthwise_conv(x, w, d, rounding).float(),
                     _plain(x, w, d, rounding).float())
        got, want = got.float(), want.float()
        bound = (_ulp(torch.maximum(conv.abs(), ref.abs()), dtype) + _slack(x, w, d)
                 + _ulp(torch.maximum(got.abs(), want.abs()), dtype))
        assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("C", [8, 16, 48, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k11_takes_any_multiple_of_8_channels(cuda, C, dtype):
    g = torch.Generator(device="cuda").manual_seed(C)
    x, w, b = _rn(g, 2, 45, 70, C, dtype=dtype), _rn(g, C, 1, 3, 3, s=0.3), _rn(g, C)
    with torch.no_grad():
        got = dw.depthwise_conv(x, w, 3, "tap", b)
        want = _plain(x, w, 3, "tap", b)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("C", [1, 4, 12, 18, 20, 30, 2056, 4100])
@pytest.mark.parametrize("kernel,d", [((3, 3), 1), ((3, 3), 3), ((3, 1), (7, 1))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k11_takes_any_channel_count(cuda, C, kernel, d, dtype):
    """C not a multiple of 8 (a thread's last group takes fewer channels,
    the copies and stores go element by element) and C past one channel
    block: "tap" bit for bit, the bias added."""
    g = torch.Generator(device="cuda").manual_seed(C)
    x, w, b = _rn(g, 2, 29, 43, C, dtype=dtype), _rn(g, C, 1, *kernel, s=0.3), _rn(g, C)
    with torch.no_grad():
        got = dw.depthwise_conv(x, w, d, "tap", b)
        want = _plain(x, w, d, "tap", b)
    assert torch.equal(_bits(got), _bits(want))


def test_k11_two_calls_give_the_same_bits(cuda):
    g = torch.Generator(device="cuda").manual_seed(3)
    x, w = _rn(g, 4, 640, 880, 64, dtype=torch.bfloat16), _rn(g, 64, 1, 1, 3, s=0.4)
    with torch.no_grad():
        a = dw.depthwise_conv(x, w, (1, 5), "once")
        b = dw.depthwise_conv(x, w, (1, 5), "once")
    assert torch.equal(_bits(a), _bits(b))


def test_k11_counts_its_launches_by_rounding(cuda):
    x = torch.zeros(1, 16, 16, 64, device="cuda", dtype=torch.bfloat16)
    before = trace.counts("launches/K11")
    with torch.no_grad():
        dw.depthwise_conv(x, torch.zeros(64, 1, 3, 3, device="cuda"), 1, "tap")
        dw.depthwise_conv(x, torch.zeros(64, 1, 3, 1, device="cuda"), (5, 1), "once")
    after = trace.counts("launches/K11")
    assert {k: after[k] - before[k] for k in after} == {"": 2, "/tap": 1, "/once": 1}


def _flagship(cuda):
    cfg = Config()
    model = get_model(cfg, device=cuda)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return model.eval()


def _twin(x, weight, dilation, rounding, bias=None):
    return dw.depthwise_plain(x, weight, dilation, rounding, bias)


def test_flagship_forward_with_k11_equals_its_twin(cuda, monkeypatch):
    """One whole-scene-sized eval forward (2 mosaics of 160^2): K11 13
    times, and the SR bit for bit that of the same forward with K11's
    kernel swapped for its twin at every site ("once" gives cuDNN's bits)."""
    model = _flagship(cuda)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(2, 160, 160, 1, generator=g, device="cuda")
    trace.reset_counts("launches/K11")
    with torch.inference_mode():
        out = model(x)
    counts = trace.counts("launches/K11")
    assert counts == {"": 13, "/tap": 11, "/once": 2}, counts
    monkeypatch.setattr(dw, "_depthwise_conv", _twin)
    with torch.inference_mode():
        all_plain = model(x)
    assert torch.equal(out, all_plain), (out - all_plain).abs().max().item()


def test_flagship_train_forward_takes_the_plain_chain(cuda, monkeypatch):
    """With a gradient wanted K11 launches at its 13 sites and the gradient
    is the plain chain's: the parameters' gradients equal, bit for bit,
    those of the same forward and backward with the twins forward."""
    model = _flagship(cuda).train()
    x = torch.rand(1, 40, 40, 1, device="cuda")

    def grads():
        out = model(x, torch.Generator(device="cuda").manual_seed(0))
        return torch.autograd.grad(out.float().mean(), list(model.parameters()),
                                   allow_unused=True)

    trace.reset_counts("launches/K11")
    got = grads()
    assert trace.counts("launches/K11") == {"": 13, "/tap": 11, "/once": 2}
    monkeypatch.setattr(dw, "_depthwise_conv", _twin)
    want = grads()
    for a, b in zip(got, want):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))

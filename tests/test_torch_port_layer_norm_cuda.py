"""K13 (csrc/layer_norm.cu) on the card against its plain twin.

At AngTrans's call (x [16384, 25, 64] bf16 + the float32 code [1, 25, 64]),
at SpaTrans's ([400, 1024, 128] bf16 + the bf16 embedded code [1, 1024,
128]), without an addend, in float32, with a [P, C] addend, and at ragged
row counts with C in {8, 24, 64, 128, 320, 640, 1024} (one vector a lane,
lanes left idle in a row's group, two and four vectors a lane). The
kernel's float32 arithmetic is the twin's, rounded where torch rounds it;
only the order of the sums over C differs. So a bf16 output lies within one
bf16 ulp of the twin's value plus 1e-5 of the scale max(1, max|twin|) (the
sums' order), and a float32 one within 1e-5 of the scale. ``launches/K13``
counts one a call, ``launches/K13/code`` one a call with an addend. With a
gradient wanted the forward is the kernel's and the gradients the twin's
(``_cuda.PlainVJP``). The port's LFT forward launches K13 16 times (8 with
the code), EPIT's 20 (none with a code), and each stays within the
chip_smoke bound of its forward on the twins.

This file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_layer_norm_cuda.py

Here (no CUDA device) every test skips.
"""

import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import _cuda
from lfsr_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain

pytestmark = pytest.mark.gpu

BF16, F32 = torch.bfloat16, torch.float32
SLACK = 1e-5  # of the scale: the float32 sums over C in another order

# (x shape, x dtype, addend (shape, dtype) or None, out dtype)
CASES = [
    ((16384, 25, 64), BF16, ((1, 25, 64), F32), BF16),     # AngTrans's call
    ((400, 1024, 128), BF16, ((1, 1024, 128), BF16), BF16),  # SpaTrans's call
    ((16384, 25, 64), BF16, None, BF16),
    ((400, 1024, 128), BF16, None, BF16),
    ((4096, 25, 64), F32, ((1, 25, 64), F32), F32),
    ((37, 1024, 128), F32, None, F32),
    ((9, 7, 64), BF16, ((7, 64), BF16), F32),
    ((37, 3, 8), BF16, ((1, 3, 8), BF16), BF16),
    ((5, 11, 8), F32, None, BF16),
    ((13, 5, 24), BF16, ((1, 5, 24), F32), BF16),
    ((3, 1001, 64), BF16, ((1, 1001, 64), BF16), BF16),
    ((7, 13, 128), F32, ((1, 13, 128), BF16), F32),
    ((3, 5, 320), BF16, ((1, 5, 320), BF16), BF16),
    ((2, 9, 640), F32, ((1, 9, 640), F32), F32),
    ((3, 5, 1024), BF16, ((1, 5, 1024), F32), BF16),
    ((1, 1, 1024), F32, None, F32),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(case, seed=0):
    shape, xdt, add, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    C = shape[-1]
    x = (rn(*shape) * 2 + 0.5).to(xdt)
    a = None if add is None else rn(*add[0]).to(add[1])
    return x, 1 + 0.2 * rn(C), 0.1 * rn(C), a


def _within(got, want):
    """|got - want| <= one ulp of got's dtype at the larger of the two,
    plus SLACK of the scale; returns (ok, max|d|)."""
    bits = 8 if got.dtype == BF16 else 24
    got, want = got.float(), want.float()
    scale = max(1.0, want.abs().max().item())
    d = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - bits)
    return bool((d <= ulp + SLACK * scale).all()), d.max().item()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_k13_matches_its_twin(cuda, case):
    x, gamma, beta, a = _operands(case)
    odt = case[3]
    trace.reset_counts("launches/K13")
    got = layer_norm(x, gamma, beta, a, odt)
    assert trace.counts("launches/K13") == {"": 1, "/code": int(a is not None)}
    want = layer_norm_plain(x, gamma, beta, a, odt)
    assert got.dtype == odt and got.shape == x.shape
    if odt == BF16:
        # within one bf16 ulp of the twin's rounded output and of its
        # float32 value before the rounding
        for ref in (want, layer_norm_plain(x, gamma, beta, a, F32)):
            ok, err = _within(got, ref)
            assert ok, err
    else:
        err, scale = _cuda.twin_error(got, want)
        assert err <= SLACK * scale, err
    assert torch.equal(got, layer_norm(x, gamma, beta, a, odt))  # two calls, the same bits


@pytest.mark.parametrize("with_add", [False, True])
def test_k13_gradient_is_the_twins(cuda, with_add):
    case = ((6, 25, 64), F32, ((1, 25, 64), F32) if with_add else None, F32)
    ops = [t for t in _operands(case, seed=1) if t is not None]
    leaves = [t.clone().requires_grad_() for t in ops]
    twins = [t.clone().requires_grad_() for t in ops]
    pick = lambda ts: (*ts[:3], ts[3] if with_add else None, F32)
    dy = torch.randn(6, 25, 64, device="cuda")
    trace.reset_counts("launches/K13")
    out = layer_norm(*pick(leaves))
    assert trace.counter("launches/K13") == 1
    want = layer_norm_plain(*pick(twins))
    err, scale = _cuda.twin_error(out.detach(), want.detach())
    assert err <= SLACK * scale, err
    for gk, gw in zip(torch.autograd.grad(out, leaves, dy), torch.autograd.grad(want, twins, dy)):
        torch.testing.assert_close(gk, gw, atol=1e-5 * max(1.0, gw.abs().max().item()), rtol=0)


@pytest.mark.parametrize("name,launches,with_code", [("LFT", 16, 8), ("EPIT", 20, 0)])
def test_model_forward_launches_k13(cuda, name, launches, with_code):
    """One bf16 forward of 2 tiles of 5 x 5 views of 32 x 32 at the
    registered width: K13's launches, and the SR within 5e-2 of the scale
    of the same forward on the twins (chip_smoke's SR bound)."""
    from lfsr_tpu_torch.bridge import init_params
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import get_model

    cfg = Config(model_name=name, compute_dtype="bfloat16")
    model = get_model(cfg, device="cuda")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.rand(2, 160, 160, 1, generator=torch.Generator(device="cuda").manual_seed(5),
                   device="cuda")
    with torch.inference_mode():
        model(x)  # the codes and masks reach the device before the count
        trace.reset_counts("launches/")
        got = model(x)
        assert trace.counts("launches/K13") == {"": launches, "/code": with_code}
        with _cuda.force_plain():
            want = model(x)
    err, scale = _cuda.twin_error(got, want)
    assert torch.isfinite(got).all() and err <= 5e-2 * scale, err

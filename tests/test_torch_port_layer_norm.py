"""K13 (``ops/layer_norm.py``: LayerNorm with the add of a position code
folded in) on the CPU, where the wrapper runs its plain twin.

- The twin is ``layer_norm_fast(x + add).to(out_dtype)`` under torch's
  promotion: bf16 + bf16 rounds the sum to bf16 (SpaTrans's embedded code),
  bf16 + float32 keeps it in float32 (AngTrans's code); a case shows the
  two promotions give different outputs.
- The wrapper on CPU tensors is the twin, bit for bit, and counts nothing.
- It raises ``ValueError`` on C not a multiple of 8 (or out of range), on
  an addend that is not [1, P, C] or [P, C], and on dtypes it does not take.
- With a gradient wanted (``_cuda.PlainVJP``), its float32 gradients are
  autograd's through the chain, for x, gamma, beta and the addend.
- LFT's and EPIT's forwards are bit for bit what they were with the old
  expression (``layer_norm_fast(tok + pe)`` and ``.to(dt)``), in float32
  and bfloat16.

The kernel itself is held to the twin on the card by
``tests/test_torch_port_layer_norm_cuda.py``.
"""

import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models import epit, lft
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.ops.cross_scan import layer_norm_fast
from lfsr_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain

from _torch_port import one_torch_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32


def _operands(shape, x_dtype, add=None, seed=0):
    """x of ``shape`` [..., P, C] (an offset, so the mean is not ~0), gamma,
    beta, and the addend ``add`` = (shape, dtype) or None."""
    g = torch.Generator().manual_seed(seed)
    P, C = shape[-2:]
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(x_dtype)
    gamma = 1 + 0.2 * torch.randn(C, generator=g)
    beta = 0.1 * torch.randn(C, generator=g)
    a = None if add is None else torch.randn(*add[0], generator=g).to(add[1])
    return x, gamma, beta, a


# (x shape, x dtype, addend (shape, dtype) or None, out dtype): AngTrans's
# call (bf16 tokens, float32 code), SpaTrans's (bf16 + bf16 code), no
# addend, float32 throughout, a [P, C] addend, C 8 and 1024
CASES = [
    ((6, 25, 64), BF16, ((1, 25, 64), F32), BF16),
    ((3, 64, 128), BF16, ((1, 64, 128), BF16), BF16),
    ((5, 25, 64), BF16, None, BF16),
    ((4, 16, 32), F32, ((1, 16, 32), F32), F32),
    ((4, 16, 32), F32, ((16, 32), BF16), F32),
    ((2, 3, 7, 8), BF16, ((7, 8), BF16), F32),
    ((3, 2, 1024), F32, None, BF16),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_the_twin_is_the_chain_under_torchs_promotion(case):
    shape, xdt, add, odt = case
    x, gamma, beta, a = _operands(shape, xdt, add)
    want = layer_norm_fast(x if a is None else x + a, gamma, beta).to(odt)
    got = layer_norm_plain(x, gamma, beta, a, odt)
    assert got.dtype == odt and torch.equal(got, want)
    if a is not None:
        # the sum's dtype is torch's promotion of the two operands'
        assert (x + a).dtype == (BF16 if xdt == a.dtype == BF16 else F32)


def test_bf16_plus_bf16_rounds_the_sum_and_a_float32_code_does_not():
    """The same values as a bf16 code and as a float32 one: the bf16 sum
    rounds before the statistics, the float32 one does not, and the outputs
    differ."""
    x, gamma, beta, a = _operands((4, 64, 128), BF16, ((1, 64, 128), BF16))
    rounded = layer_norm_plain(x, gamma, beta, a, F32)
    kept = layer_norm_plain(x, gamma, beta, a.float(), F32)
    assert torch.equal(rounded, layer_norm_fast((x + a).float(), gamma, beta))
    assert torch.equal(kept, layer_norm_fast(x.float() + a.float(), gamma, beta))
    assert not torch.equal(rounded, kept)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_the_wrapper_on_the_cpu_is_the_twin(case):
    shape, xdt, add, odt = case
    x, gamma, beta, a = _operands(shape, xdt, add, seed=1)
    trace.reset_counts("launches/")
    got = layer_norm(x, gamma, beta, a, odt)
    assert torch.equal(got, layer_norm_plain(x, gamma, beta, a, odt))
    assert trace.counts("launches/K13") == {"": 0, "/code": 0}


def _bad_calls():
    x, gamma, beta, a = _operands((2, 5, 16), BF16, ((1, 5, 16), BF16))
    half = torch.float16
    yield "C % 8", (torch.zeros(2, 5, 12), torch.ones(12), torch.zeros(12), None, F32)
    yield "C > 1024", (torch.zeros(1, 2, 1032), torch.ones(1032), torch.zeros(1032), None, F32)
    yield "x 1-d", (torch.zeros(16), gamma, beta, None, F32)
    yield "add [2, P, C]", (x, gamma, beta, a.expand(2, 5, 16), BF16)
    yield "add [1, 1, C]", (x, gamma, beta, a[:, :1], BF16)
    yield "add [C]", (x, gamma, beta, a[0, 0], BF16)
    yield "add [1, P, 1]", (x, gamma, beta, a[..., :1], BF16)
    yield "add [P + 1, C]", (x, gamma, beta, torch.zeros(6, 16), BF16)
    yield "x float16", (x.to(half), gamma, beta, a, BF16)
    yield "add float16", (x, gamma, beta, a.to(half), BF16)
    yield "out float16", (x, gamma, beta, a, half)
    yield "gamma bf16", (x, gamma.to(BF16), beta, a, BF16)
    yield "beta [C + 8]", (x, gamma, torch.zeros(24), a, BF16)


@pytest.mark.parametrize("what,args", list(_bad_calls()), ids=[w for w, _ in _bad_calls()])
def test_refuses_what_it_does_not_take(what, args):
    with pytest.raises(ValueError, match="layer_norm"):
        layer_norm(*args)


@pytest.mark.parametrize("with_add", [False, True])
def test_gradient_is_autograd_through_the_chain(with_add):
    x, gamma, beta, a = _operands((3, 5, 16), F32, ((1, 5, 16), F32) if with_add else None)
    w = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(9))
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta, *(() if a is None else (a,)))]

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in leaves]
        xi, gi, bi = ins[:3]
        out = fn(xi, gi, bi, ins[3] if with_add else None, F32)
        return torch.autograd.grad((out * w).sum(), ins)

    got = grads(layer_norm)
    want = grads(lambda xi, gi, bi, ai, dt: layer_norm_fast(xi if ai is None else xi + ai,
                                                            gi, bi).to(dt))
    for gk, gw in zip(got, want):
        assert torch.allclose(gk, gw, rtol=0, atol=1e-6 * max(1.0, gw.abs().max().item()))


def _old_layer_norm(x, gamma, beta, add, out_dtype):
    """The models' expression before K13: ``self._ln(ln, tok + pe)`` (or
    ``self._ln(ln, x)``), ``_ln`` being ``layer_norm_fast(...).to(dt)``."""
    return layer_norm_fast(x + add if add is not None else x, gamma, beta).to(out_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,module", [("LFT", lft), ("EPIT", epit)])
def test_the_models_forwards_are_what_they_were(name, module, dtype, monkeypatch):
    cfg = Config(model_name=name, compute_dtype=dtype,
                 model_kwargs={"n_blocks": 1, "channels": 16})
    m = get_model(cfg, device="cpu")
    m.load_state_dict(init_params(cfg, torch.Generator().manual_seed(3)))
    x = torch.rand(1, 40, 40, 1, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        new = m(x)
        monkeypatch.setattr(module, "layer_norm", _old_layer_norm)
        old = m(x)
    assert torch.equal(new, old)

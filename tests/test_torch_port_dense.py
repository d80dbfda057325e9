"""The biased products (``models.common.biased_product``): a Dense layer's
bias, and LF-DET's spatial reduction's, added in the product's epilogue by
one ``torch.addmm``, on the CPU.

- bfloat16: within one bf16 ulp of the float32 formula rounded once (the
  bf16 operands' product plus the bf16 bias, exact in float32 sums), and
  in all no farther from it than the old form, which rounds the product
  and then the sum.
- float32: within 1e-6 of the scale of the old form ``x @ W + b``, and its
  gradients (x, W, b) those of the old form.
- A Dense layer with no bias (LFT's, EPIT's, the flagship's) takes the
  plain product, bit for bit, and counts nothing.
- ``dense/bias_epilogue`` counts every biased product: 108 a forward of
  LF-DET at its four mix blocks, 0 of LFT, EPIT and the flagship.
"""

import pytest
import torch
import torch.nn as nn

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models import lf_det
from lfsr_tpu_torch.models.common import biased_product, dense
from lfsr_tpu_torch.models.registry import get_model

from _torch_port import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
# (rows, C_in, C_out): LF-DET's q / out, kv, Mix-FFN in and out, and the
# spatial reduction's 2x2 patches of 64 channels
SHAPES = [(300, 64, 64), (300, 64, 128), (300, 64, 256), (300, 256, 64), (75, 256, 64)]


def _operands(m, k, n, seed=0):
    """Token rows x [3, m // 3, k], a Linear's weight [n, k] and bias [n],
    every value exact in bf16."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, m // 3, k, generator=g).to(BF16).float()
    w = (torch.randn(n, k, generator=g) * k**-0.5).to(BF16).float()
    b = (torch.randn(n, generator=g) * 2).to(BF16).float()
    return x, w, b


def _linear(w, b):
    lin = nn.Linear(w.shape[1], w.shape[0], bias=b is not None)
    with torch.no_grad():
        lin.weight.copy_(w)
        if b is not None:
            lin.bias.copy_(b)
    return lin


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |v| (8 significant bits), v float32."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bf16_rounds_once_within_an_ulp_of_the_float32_formula(m, k, n):
    x, w, b = _operands(m, k, n)
    exact = x @ w.t() + b  # float32 sums of exact bf16 operands
    got = dense(_linear(w, b), x.to(BF16), BF16)
    assert got.dtype == BF16 and got.shape == (3, m // 3, n)
    assert ((got.float() - exact).abs() <= _ulp(exact)).all()
    old = x.to(BF16) @ w.t().to(BF16) + b.to(BF16)  # the product rounded, then the sum
    assert (got.float() - exact).abs().sum() <= (old.float() - exact).abs().sum()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_float32_is_the_old_form_and_so_are_its_gradients(m, k, n):
    x, w, b = _operands(m, k, n, seed=1)
    gy = torch.randn(3, m // 3, n, generator=torch.Generator().manual_seed(2))
    outs, grads = [], []
    for new in (True, False):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        y = biased_product(xs, ws.t(), bs, torch.float32) if new else xs @ ws.t() + bs
        outs.append(y.detach())
        grads.append(torch.autograd.grad((y * gy).sum(), (xs, ws, bs)))
    scale = max(1.0, outs[1].abs().max().item())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6 * scale
    for g_new, g_old in zip(*grads):
        assert (g_new - g_old).abs().max().item() <= 1e-6 * max(1.0, g_old.abs().max().item())


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_no_bias_is_the_plain_product_bit_for_bit_and_counts_nothing(dt):
    x, w, _ = _operands(300, 64, 128, seed=3)
    trace.reset_counts("dense/")
    got = dense(_linear(w, None), x, dt)
    assert torch.equal(got, x.to(dt) @ w.t().to(dt))
    assert trace.counter("dense/bias_epilogue") == 0


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_the_spatial_reductions_bias_rides_in_its_product(monkeypatch, dt):
    """``_reduce``'s 2x2 stride-2 patch product + bias, read where it enters
    the LayerNorm: bf16 within an ulp of the float32 formula, float32 (the
    old form's arithmetic) within 1e-6 of the scale."""
    dim, h, w = 16, 7, 7  # odd sides: the last row and column dropped
    attn = lf_det._Attention(dim, 2, dt)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_((torch.randn(p.shape, generator=g) * 0.3).to(BF16).float())
    x = torch.randn(2, h * w, dim, generator=g).to(BF16).to(dt)
    seen = []
    monkeypatch.setattr(lf_det, "layer_norm", lambda red, *a: seen.append(red) or red)
    attn._reduce(x, h, w)
    (red,) = seen
    patches = x.float().reshape(2, h, w, dim)[:, :6, :6].reshape(2, 3, 2, 3, 2, dim)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(2, 9, 4 * dim)
    conv = attn.Conv_0
    wk = conv.weight.permute(2, 3, 1, 0).reshape(4 * dim, dim)
    exact = patches @ wk + conv.bias  # the old form in float32; bf16-exact operands
    assert red.dtype == dt and red.shape == (2, 9, dim)
    if dt == BF16:
        assert ((red.float() - exact).abs() <= _ulp(exact)).all()
    else:
        assert (red - exact).abs().max().item() <= 1e-6 * max(1.0, exact.abs().max().item())


@pytest.mark.parametrize("name,kwargs,side,want", [
    ("LF_DET", {"channels": 16}, 6, 108),  # 4 mix blocks of 2 x 6 + 3 x 5
    ("LFT", {"n_blocks": 1}, 8, 0),
    ("EPIT", {"n_blocks": 1, "channels": 16}, 8, 0),
    ("LFMambaX", {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}, 8, 0),
])
def test_a_forward_counts_its_biased_products(name, kwargs, side, want):
    cfg = Config(model_name=name, compute_dtype="float32", model_kwargs=kwargs)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    model.eval()
    trace.reset_counts("dense/")
    with torch.inference_mode():
        model(torch.rand(1, 5 * side, 5 * side, 1))
    assert trace.counter("dense/bias_epilogue") == want

"""K14 (csrc/conv_silu.cu) on the card against its plain twin, the chain
``conv_silu``, bit for bit (the raw bits, so a signed zero counts too).

At the scans of the Synth ([4, 518400, 80]) and Real ([4, 563200, 80])
whole-scene dispatches, of the batch-8 train step ([8, 25600, 80]) and of
tiled eval ([2, 25600, 80]), in bf16 and float32, with xs as the first half
of in_proj's output xz and wconv as the model views conv1d's weight; on the
16-byte lanes there and on the one-channel lanes (the dryrun's Di 20 in
bf16, a row stride off the lane, xs off 16 bytes); at K 1-8, L shorter than
K, a run of one position, and a contiguous xs. ``launches/K14`` counts one a
call and ``launches/K14/<path>`` the lanes it took. With a gradient wanted
the forward is the kernel's and the gradients the twin's
(``_cuda.PlainVJP``). A Mamba forward launches K14 once under ``'pallas'``
and ``'gated'``, never under ``'fused'`` and ``'assoc'``. The flagship's
eval forward launches it 12 times and gives the SR of the same forward
with K14's kernel swapped for the chain, bit for bit; its train forward
runs the chain and launches none.

This file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_conv_silu_cuda.py

Here (no CUDA device) every test skips.
"""

import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.models.ssm import Mamba
from lfsr_tpu_torch.ops import scan
from lfsr_tpu_torch.ops.scan import conv_silu_fused, conv_silu_path, conv_silu_plain

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

BF16, F32 = torch.bfloat16, torch.float32

# (B, L, Di) of the main paths' scans
SHAPES = {"synth": (4, 518400, 80), "real": (4, 563200, 80), "train": (8, 25600, 80),
          "tiled": (2, 25600, 80)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(B, L, Di, K, dtype, row=None, offset=0, seed=0):
    """xs = xz[..., offset:offset + Di] of xz [B, L, row] (row 2 Di: in_proj's
    output), wconv [K, Di] viewed from [Di, 1, K], bconv [Di]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    xz = rn(B, L, row or 2 * Di).to(dtype)
    return xz[..., offset : offset + Di], (0.5 * rn(Di, 1, K))[:, 0, :].t(), 0.5 * rn(Di)


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


def _check(xs, wconv, bconv, path):
    trace.reset_counts("launches/K14")
    got = conv_silu_fused(xs, wconv, bconv)
    want = conv_silu_plain(xs, wconv, bconv)
    assert trace.counts("launches/K14") == {"": 1, "/vec": int(path == "vec"),
                                            "/elem": int(path == "elem")}
    assert got.dtype == xs.dtype and got.shape == xs.shape and got.is_contiguous()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("where", SHAPES)
def test_k14_is_the_chain_at_the_main_paths_shapes(cuda, where, dtype):
    xs, wconv, bconv = _operands(*SHAPES[where], 4, dtype)
    assert conv_silu_path(xs, xs.stride(1)) == "vec"
    _check(xs, wconv, bconv, "vec")


# (B, L, Di, K, dtype, row, offset, path): the dryrun's Di 20 (bf16: one
# channel a lane; float32: 4-channel lanes), rows off the lane, xs off 16
# bytes, K 1-8, L shorter than K, one position, Di past a CTA's lanes
CASES = [
    (4, 6400, 20, 4, BF16, None, 0, "elem"),
    (4, 6400, 20, 4, F32, None, 0, "vec"),
    (3, 1000, 80, 4, BF16, 161, 0, "elem"),
    (3, 1000, 80, 4, BF16, 160, 1, "elem"),
    (3, 1000, 80, 4, BF16, 160, 8, "vec"),
    (2, 777, 37, 3, F32, None, 0, "elem"),
    (2, 300, 16, 1, BF16, None, 0, "vec"),
    (2, 300, 16, 2, F32, None, 0, "vec"),
    (2, 300, 24, 5, BF16, None, 0, "vec"),
    (2, 300, 24, 6, F32, None, 0, "vec"),
    (2, 300, 24, 7, BF16, None, 0, "vec"),
    (2, 300, 24, 8, F32, None, 0, "vec"),
    (5, 2, 80, 4, BF16, None, 0, "vec"),
    (5, 3, 20, 8, BF16, None, 0, "elem"),
    (3, 1, 80, 4, F32, None, 0, "vec"),
    (2, 50, 2064, 4, BF16, None, 0, "vec"),
    (2, 50, 301, 2, F32, None, 0, "elem"),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_k14_is_the_chain_on_both_lanes(cuda, case):
    B, L, Di, K, dtype, row, offset, path = case
    xs, wconv, bconv = _operands(B, L, Di, K, dtype, row, offset, seed=1)
    assert conv_silu_path(xs, xs.stride(1)) == path
    _check(xs, wconv, bconv, path)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_k14_on_a_contiguous_xs_and_two_calls(cuda, dtype):
    xs, wconv, bconv = _operands(4, 9000, 80, 4, dtype, seed=2)
    xs = xs.contiguous()
    _check(xs, wconv, bconv, "vec")
    assert torch.equal(conv_silu_fused(xs, wconv, bconv), conv_silu_fused(xs, wconv, bconv))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_k14_gradient_is_the_twins(cuda, dtype):
    ops = _operands(2, 513, 80, 4, dtype, seed=3)
    leaves = [t.detach().clone().requires_grad_() for t in ops]
    twins = [t.detach().clone().requires_grad_() for t in ops]
    dy = torch.randn(2, 513, 80, device="cuda").to(dtype)
    trace.reset_counts("launches/K14")
    out = conv_silu_fused(*leaves)
    assert trace.counter("launches/K14") == 1
    want = conv_silu_plain(*twins)
    assert torch.equal(_bits(out.detach()), _bits(want.detach()))
    for gk, gw in zip(torch.autograd.grad(out, leaves, dy), torch.autograd.grad(want, twins, dy)):
        assert torch.equal(gk, gw)


@pytest.mark.parametrize("impl,launches", [("pallas", 1), ("gated", 1), ("fused", 0),
                                           ("assoc", 0)])
def test_a_mamba_forward_launches_k14(cuda, impl, launches):
    m = Mamba(64, 16, 4, 1.25, scan_impl=impl, dtype=BF16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device="cuda"))
        m.A_log.copy_(torch.log(torch.arange(1, 17, dtype=F32, device="cuda")).repeat(80, 1))
    x = torch.randn(2, 4096, 64, generator=g, device="cuda")
    with torch.inference_mode():
        trace.reset_counts("launches/")
        y = m(x)
    assert torch.isfinite(y.float()).all()
    assert trace.counts("launches/K14") == {"": launches, "/vec": launches, "/elem": 0}


def _flagship(cuda):
    cfg = Config()
    model = get_model(cfg, device=cuda)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return model.eval()


def test_flagship_forward_with_k14_equals_the_chains(cuda, monkeypatch):
    """One eval forward of 2 mosaics of 160^2: K14 12 times, on 16-byte
    lanes, and the SR bit for bit that of the same forward with the chain
    in K14's place."""
    model = _flagship(cuda)
    x = torch.rand(2, 160, 160, 1, generator=torch.Generator(device="cuda").manual_seed(1),
                   device="cuda")
    trace.reset_counts("launches/K14")
    with torch.inference_mode():
        out = model(x)
    assert trace.counts("launches/K14") == {"": 12, "/vec": 12, "/elem": 0}
    monkeypatch.setattr(scan, "_conv_silu_fused", conv_silu_plain)
    with torch.inference_mode():
        chain = model(x)
    assert torch.equal(out, chain), (out.float() - chain.float()).abs().max().item()


def test_flagship_train_forward_runs_the_chain(cuda):
    """With a gradient wanted the blocks run the chain under autograd (K14
    has no backward kernel): no K14 launch, finite gradients."""
    model = _flagship(cuda).train()
    x = torch.rand(1, 40, 40, 1, device="cuda")
    trace.reset_counts("launches/K14")
    out = model(x, torch.Generator(device="cuda").manual_seed(0))
    grads = torch.autograd.grad(out.float().mean(), list(model.parameters()), allow_unused=True)
    assert trace.counts("launches/K14") == {"": 0, "/vec": 0, "/elem": 0}
    assert all(g is None or torch.isfinite(g).all() for g in grads)

"""K12 (csrc/local_attention.cu) on the card against its plain twin.

At LFT's tiled call (q, k, v [400, 1024, 128], 8 heads of 16, 5 x 5 over
32 x 32 tokens) and at the edge geometries of the CPU tests (h != w, a
side under the window, the even 4 x 6 window, 7 x 7, 1 x 1), head dims 8,
16 and 32 (each at a head count that fills the kernel's 64-channel groups), in bfloat16 (tensor cores: P rounded to bf16 before P V and the
output to bf16, so within 2 bf16 ulps of the output's scale) and float32
(CUDA cores: 1e-5 of the scale); ``launches/K12`` counts one a call, on the
kernel ``kernel_path`` names. With a gradient wanted the forward is the
kernel's and the gradient the twin's autograd (``_cuda.PlainVJP``). The
wrapper refuses a head dim, a head count or a window it does not take. The port's LFT
forward on the card at the cell's batch (16 tiles of 5 x 5 views of 32 x
32) against the plain reference (``portbench/reference/lft.py``): within
2x of the distance bf16 rounding puts between the reference and itself,
K12 and K8 four launches each.

This file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_local_attention_cuda.py

Here (no CUDA device) every test skips.
"""

import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import local_attention as la

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

# (B, h, w, heads, hd, k_r, k_c): the cell's call, then the edge geometries
CASES = [
    (400, 32, 32, 8, 16, 5, 5),
    (3, 6, 10, 8, 16, 5, 5),
    (2, 3, 17, 8, 16, 5, 5),
    (2, 9, 2, 4, 16, 5, 5),
    (3, 7, 9, 8, 16, 4, 6),
    (2, 11, 13, 2, 32, 7, 7),
    (2, 5, 6, 16, 8, 5, 5),
    (2, 8, 8, 4, 32, 3, 5),
    (1, 4, 5, 8, 16, 1, 1),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(case, dtype, seed=0):
    B, h, w, heads, hd = case[:5]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(B, h * w, heads * hd, generator=g, device="cuda") * 1.5).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CASES)
def test_k12_matches_its_twin(cuda, case, dtype):
    B, h, w, heads, hd, k_r, k_c = case
    q, k, v = _qkv(case, dtype)
    trace.reset_counts("launches/K12")
    got = la.local_window_mha(q, k, v, heads, h, w, k_r, k_c)
    path = la.kernel_path(dtype)
    assert trace.counts("launches/K12") == {"": 1, f"/{path}": 1,
                                             f"/{'fma' if path == 'mma' else 'mma'}": 0}
    want = la.local_window_plain(q, k, v, heads, h, w, k_r, k_c)
    assert got.dtype == dtype and got.shape == q.shape
    scale = max(1.0, want.float().abs().max().item())
    tol = 2 * 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, err


def test_k12_gradient_is_the_twins(cuda):
    case = (3, 7, 9, 8, 16, 5, 5)
    B, h, w, heads, hd, k_r, k_c = case
    leaves = [t.requires_grad_() for t in _qkv(case, torch.float32, seed=1)]
    twins = [t.detach().clone().requires_grad_() for t in leaves]
    dy = torch.randn(B, h * w, heads * hd, device="cuda")
    trace.reset_counts("launches/K12")
    out = la.local_window_mha(*leaves, heads, h, w, k_r, k_c)
    assert trace.counter("launches/K12") == 1
    want = la.local_window_plain(*twins, heads, h, w, k_r, k_c)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    got_g = torch.autograd.grad(out, leaves, dy)
    want_g = torch.autograd.grad(want, twins, dy)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,heads,h,w,k_r,k_c", [
    ((2, 64, 48), 8, 8, 8, 5, 5),      # head dim 6
    ((2, 64, 512), 8, 8, 8, 5, 5),     # head dim 64
    ((2, 64, 128), 8, 8, 8, 8, 5),     # window 8
    ((2, 64, 128), 8, 8, 8, 5, 0),     # window 0
    ((2, 64, 128), 8, 8, 7, 5, 5),     # h * w != L
    ((2, 64, 48), 3, 8, 8, 5, 5),      # 3 heads of 16: not whole 64-channel groups
    ((2, 64, 32), 4, 8, 8, 5, 5),      # 4 heads of 8
    ((2, 64, 96), 3, 8, 8, 5, 5),      # 3 heads of 32
])
def test_k12_refuses_what_it_does_not_take(cuda, shape, heads, h, w, k_r, k_c):
    q = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        la.local_window_mha(q, q, q, heads, h, w, k_r, k_c)


def test_lft_forward_on_the_card_against_the_reference(cuda):
    """16 tiles of 5 x 5 views of 32 x 32 LR pixels, bf16, seeded weights."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import get_model
    from portbench.harness.weights import make_weights
    from portbench.reference import lft as ref
    from portbench.reference.common import Prec

    cfg = Config(model_name="LFT", compute_dtype="bfloat16")
    weights = make_weights(ref.param_specs({}), 2147483647 + 18, "cuda")
    model = get_model(cfg, device="cuda")
    model.load_state_dict(weights, strict=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand(16, 160, 160, 1, generator=g, device="cuda")
    trace.reset_counts("launches/")
    with torch.inference_mode():
        got = model(x)
    assert trace.counter("launches/K12") == 4 and trace.counter("launches/K12/mma") == 4
    assert trace.counter("launches/K8") == 4 and trace.counter("launches/K8/fma") == 4
    want, base = [], []
    with torch.no_grad():
        for i in range(0, 16, 4):  # the reference gathers each window: 4 tiles a call
            want.append(ref.forward(weights, x[i : i + 4], {}))
            base.append(ref.forward(weights, x[i : i + 4], {}, q=Prec("bfloat16")))
    want, base = torch.cat(want), torch.cat(base)
    assert torch.isfinite(got).all() and got.shape == want.shape == (16, 640, 640, 1)
    gap = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(base - want)).item()
    assert gap < 2.0, gap

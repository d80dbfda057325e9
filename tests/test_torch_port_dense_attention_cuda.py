"""K15 (csrc/dense_attention.cu) on the card against its plain formula.

At LF-DET's four sites of a 16-tile call (spatial: q [400, 1024, 64], k and
v [400, 256, 64]; the MacPI windows: [16384, 25, 64], [4096, 100, 64],
[1936, 225, 64]; 4 heads of 16, k and v the two halves of one projection)
and at edge shapes (lengths 1 and off 16, Lq != Lk both ways, Lk 1,024
where the tensor-core kernel stages 32 channels, D 16 and 32, batches that
do not fill the last CTA), in bfloat16 (tensor cores: P rounded to bf16
before P V and the output to bf16, so within 2 bf16 ulps of the output's
scale of the float32 formula on the same operands, and no farther from it
than the bf16 twin, which rounds the scores too) and float32 (CUDA
cores: 1e-5 of the scale); ``launches/K15`` counts one a call, on the
kernel ``kernel_path`` names. With a gradient wanted the forward is the
kernel's and the gradient the twin's autograd (``_cuda.PlainVJP``). The
port's LF-DET forward at the cell's geometry (tiles of 5 x 5 views of
32 x 32) against the plain reference (``portbench/reference/lf_det.py``):
within 2x of the distance bf16 rounding puts between the reference and
itself, with K15 20, K13 48 and K11 20 launches a forward.

This file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_dense_attention_cuda.py

Here (no CUDA device) every test skips.
"""

import numpy as np
import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import dense_attention as da

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

# (B, Lq, Lk, D, heads): the cell's four sites, then edge shapes
SITES = [(400, 1024, 256, 64, 4), (16384, 25, 25, 64, 4), (4096, 100, 100, 64, 4),
         (1936, 225, 225, 64, 4)]
EDGES = [(3, 1, 1, 64, 4), (5, 7, 33, 64, 4), (2, 130, 17, 64, 4), (9, 33, 200, 64, 4),
         (2, 300, 1024, 64, 4), (3, 1024, 1024, 64, 4), (4, 40, 24, 32, 2), (3, 19, 50, 16, 1),
         (2, 20, 20, 128, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(case, dtype, seed=0):
    """q [B, Lq, D] and k, v the two halves of one [B, Lk, 2D] tensor."""
    B, Lq, Lk, D, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(B, Lq, D, generator=g, device="cuda") * 1.5).to(dtype)
    kv = (torch.randn(B, Lk, 2 * D, generator=g, device="cuda") * 1.5).to(dtype)
    return q, kv[..., :D], kv[..., D:]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SITES + EDGES)
def test_k15_matches_the_formula(cuda, case, dtype):
    heads = case[-1]
    q, k, v = _operands(case, dtype)
    trace.reset_counts("launches/K15")
    got = da.dense_mha(q, k, v, heads)
    path = da.kernel_path(dtype)
    other = "fma" if path == "mma" else "mma"
    assert trace.counts("launches/K15") == {"": 1, f"/{path}": 1, f"/{other}": 0}
    assert got.dtype == dtype and got.shape == q.shape
    want = da.dot_product_attention(q.float(), k.float(), v.float(), heads)
    scale = max(1.0, want.abs().max().item())
    tol = 2 * 2.0**-8 if dtype == torch.bfloat16 else 1e-5
    err = (got.float() - want).abs().max().item()
    assert err <= tol * scale, err
    if dtype == torch.bfloat16:  # the twin rounds the scores and P, as flax does: farther
        twin = da.dot_product_attention(q, k, v, heads).float()
        assert err <= (twin - want).abs().max().item() + 2.0**-8 * scale


def test_k15_takes_the_tensor_cores_at_every_site(cuda):
    for B, Lq, Lk, D, heads in SITES:
        assert da.kernel_path(torch.bfloat16) == "mma"
        cw, S, QB = da.mma_plan(B, Lq, Lk, D)
        assert cw == 64 and da.mma_smem_bytes(Lk, cw, S, QB) <= da.PACK_BYTES


def test_two_calls_are_bit_equal(cuda):
    q, k, v = _operands(SITES[0], torch.bfloat16, seed=3)
    a, b = da.dense_mha(q, k, v, 4), da.dense_mha(q, k, v, 4)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_gradient_is_the_twins(cuda, dtype):
    case = (3, 40, 24, 64, 4)
    leaves = [t.detach().clone().requires_grad_(True) for t in _operands(case, dtype, seed=5)]
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    g = torch.randn(3, 40, 64, device="cuda").to(dtype)
    trace.reset_counts("launches/K15")
    out = da.dense_mha(*leaves, 4)
    assert trace.counter("launches/K15") == 1
    torch.autograd.backward(out, g)
    torch.autograd.backward(da.dot_product_attention(*ref, 4), g)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)


def test_the_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v = _operands((2, 8, 8, 64, 4), torch.bfloat16)
    with pytest.raises(ValueError):
        da.dense_mha(q, k, v, 3)  # D % heads
    with pytest.raises(ValueError):
        da.dense_mha(q[:, :, :48].contiguous(), k[..., :48], v[..., :48], 1)  # hd 48
    for dtype in (torch.bfloat16, torch.float32):  # hd 8 and 32: hd 16 alone, on both kernels
        for heads in (8, 2):
            with pytest.raises(ValueError):
                da.dense_mha(q.to(dtype), k.to(dtype), v.to(dtype), heads)
    with pytest.raises(ValueError):
        da.dense_mha(q, k.float(), v, 4)  # dtypes differ
    big = torch.zeros(1, 1025, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        da.dense_mha(big, big, big, 4)  # Lk past MAX_LEN


def test_the_lf_det_forward_matches_the_reference(cuda):
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import get_model
    from portbench.harness.weights import make_weights
    from portbench.reference import lf_det as ref
    from portbench.reference.common import Prec

    w = make_weights(ref.param_specs({}), 2**31 + 22, "cuda")
    model = get_model(Config(model_name="LF_DET", compute_dtype="bfloat16"))
    model.load_state_dict(w, strict=True)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 160, 160, 1), np.float32)).cuda()
    trace.reset_counts("launches/")
    with torch.inference_mode():
        got = model(x)
        counts = {k: trace.counter(f"launches/{k}") for k in ("K15", "K13", "K11")}
        want = ref.forward(w, x, {})
        own = ref.forward(w, x, {}, q=Prec("bfloat16"))
    assert counts == {"K15": 20, "K13": 48, "K11": 20}
    assert trace.counter("launches/K15/mma") == 20
    gap = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(own - want)
    assert gap.item() <= 2.0, gap.item()

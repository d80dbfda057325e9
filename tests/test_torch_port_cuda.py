"""CUDA kernels of the port against their plain twins (needs the card).

Each kernel runs on CUDA tensors and is compared with its plain PyTorch
twin on the same inputs: float32 with TF32 off to 1e-4 of the output scale
(sums in another order, ``expf``/``rsqrtf`` rounding), bfloat16 to 3e-2
(a few bf16 roundings at other places; float32 outputs from bf16 inputs,
K2's states and K3's gradients, to 1e-4), each output against its own
scale. K9b and K9c read B and C, z and xs at the row strides the model
gives them (slices of dbc and of in_proj's output), also at an L that is
not a multiple of 64. Also: launch counters, K2's y equal to K1's bit for
bit, the gradients of the six autograd Functions (the scan's K2 + K3, and
K4-K8) on the kernels vs on the twins, a block at K7's gate and a block
under each of ``scan_impl='gated'``/``'fused'`` on the kernels vs on the
plain twins, the small flagship and a one-block EPIT on CUDA vs on the
CPU.

This file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Here (no CUDA device) every test skips.
"""

import numpy as np
import pytest
import torch

from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.models.epit import band_mask
from lfsr_tpu_torch.ops import _cuda, block, cross_scan, masked_attention, scan, window_attention
from lfsr_tpu_torch.ops.block import LN_MSL_MIN_PIXELS

pytestmark = pytest.mark.gpu

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
# by output dtype: a float32 output (K2's states, K3's gradients) from bf16
# inputs is computed in float32 on both sides
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rn(g, *shape, s=1.0, dtype=torch.float32, dev="cuda"):
    return (torch.randn(*shape, generator=g) * s).to(dev, dtype)


def _cases(g, dtype, B, H, W, C, N):
    Di, R, T, c4 = int(1.25 * C), -(-C // 16), 64, C // 4
    L = H * W
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(Di, 1).cuda()
    scan_args = (_rn(g, B, L, Di, s=0.5, dtype=dtype), _rn(g, B, L, R + 2 * N, s=0.5, dtype=dtype),
                 _rn(g, R, Di, s=0.3), _rn(g, Di, s=0.1), A, torch.ones(Di, device="cuda"))
    with torch.no_grad():
        states = scan.selective_scan_proj_states(*scan_args)[1]
    cases = {
        "K1": (scan.selective_scan_proj, scan.selective_scan_proj_plain, scan_args),
        "K2": (scan.selective_scan_proj_states, scan.selective_scan_proj_states_plain, scan_args),
        "K3": (scan.selective_scan_proj_bwd, scan.selective_scan_proj_bwd_plain,
               (*scan_args[:2], _rn(g, B, L, Di, dtype=dtype), *scan_args[2:5], states)),
        "K4": (cross_scan.cross_scan_gather, cross_scan.cross_scan_gather_plain,
               (_rn(g, B, H, W, C, dtype=dtype), 1 + _rn(g, C, s=0.2), _rn(g, C, s=0.1))),
        "K5": (cross_scan.cross_scan_scatter, cross_scan.cross_scan_scatter_plain,
               (_rn(g, B, L, C, dtype=dtype), _rn(g, B, H, W, C, dtype=dtype),
                _rn(g, C, C, s=C**-0.5, dtype=dtype), torch.full((1,), 0.15, device="cuda"))),
        "K6": (window_attention.window_mha_fused, window_attention.window_mha_plain,
               (_rn(g, B, H, W, C, dtype=dtype), _rn(g, C, 3 * C, s=C**-0.5),
                _rn(g, C, C, s=C**-0.5), 1 + _rn(g, C, s=0.2), _rn(g, C, s=0.1),
                _rn(g, T, 4 * T, s=0.02), torch.full((1,), 0.25, device="cuda"))),
        "K7": (block.ln_msl, block.ln_msl_plain,
               (_rn(g, B, H, W, C, dtype=dtype), 1 + _rn(g, C, s=0.2), _rn(g, C, s=0.1),
                _rn(g, c4, C, s=C**-0.5, dtype=dtype), _rn(g, C - c4, C, s=C**-0.5, dtype=dtype),
                _rn(g, 3, 3, C - c4, s=0.3, dtype=dtype))),
    }
    # K9b/K9c operands as the model gives them: B and C slices of dbc, xs and
    # z the halves of in_proj's output
    dbc = _rn(g, B, L, R + 2 * N, s=0.5, dtype=dtype)
    xz = _rn(g, B, L, 2 * Di, dtype=dtype)
    return {
        **cases,
        "K9b": (scan.scan_gated_fused, scan.scan_gated_plain,
                (_rn(g, B, L, Di, s=0.5, dtype=dtype), _rn(g, B, L, Di, s=0.5, dtype=dtype), A,
                 dbc[..., R : R + N], dbc[..., R + N :], xz[..., Di:],
                 torch.ones(Di, device="cuda"), _rn(g, Di, C, s=Di**-0.5, dtype=dtype), True)),
        "K9c": (scan.mamba_inner_fused, scan.mamba_inner_plain,
                (xz[..., :Di], xz[..., Di:], _rn(g, 4, Di, s=0.3), _rn(g, Di, s=0.1),
                 _rn(g, Di, R + 2 * N, s=Di**-0.5), _rn(g, R, Di, s=0.3), _rn(g, Di, s=0.1), A,
                 torch.ones(Di, device="cuda"))),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K9b", "K9c"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 4), (2, 160, 160, 64, 16),
                                   (2, 40, 72, 64, 16)],
                         ids=["small", "flagship", "non_square"])
def test_kernel_matches_plain_twin(cuda, name, dtype, shape):
    B, H, W, C, N = shape  # batch, map height and width, channels, d_state
    kern, plain, args = _cases(torch.Generator().manual_seed(0), dtype, B, H, W, C, N)[name]
    before = kern.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = plain(*args)
    for a, b in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        err, scale = _cuda.twin_error(a, b)
        assert err <= TOL[a.dtype] * scale, err


@pytest.mark.parametrize("name", ["K9b", "K9c"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_at_a_ragged_length_matches_plain_twin(cuda, name, dtype):
    """L = 25 x 39 = 975, a multiple of neither 64 nor 128 (the TPU pads;
    the kernels take any L)."""
    kern, plain, args = _cases(torch.Generator().manual_seed(7), dtype, 2, 25, 39, 64, 16)[name]
    got = kern(*args)
    torch.cuda.synchronize()
    err, scale = _cuda.twin_error(got, plain(*args))
    assert got.dtype == dtype and err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("impl", ["gated", "fused"])
def test_block_under_each_scan_impl_matches_its_plain_twins(cuda, impl):
    cfg = Config(compute_dtype="bfloat16", model_kwargs={"scan_impl": impl})
    model = get_model(cfg, device=cuda)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.randn(2, 40, 72, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
    kern = {"gated": scan.scan_gated_fused, "fused": scan.mamba_inner_fused}[impl]
    before = (kern.launches, scan.selective_scan_proj.launches)
    with torch.inference_mode():
        got = model.block_0(x)
        torch.cuda.synchronize()
        with _cuda.force_plain():
            want = model.block_0(x)
    assert (kern.launches, scan.selective_scan_proj.launches) == (before[0] + 1, before[1])
    err, scale = _cuda.twin_error(got, want)
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_y_equals_k1_y(cuda, dtype):
    args = _cases(torch.Generator().manual_seed(1), dtype, 2, 40, 72, 64, 16)["K1"][2]
    y, states = scan.selective_scan_proj_states(*args)
    assert torch.equal(y, scan.selective_scan_proj(*args))
    assert states.dtype == torch.float32 and states.shape == (2, -(-40 * 72 // 64), 16, 80)


@pytest.mark.parametrize("name", ["K1", "K4", "K5", "K6", "K7"])
def test_function_gradients_match_plain_twin(cuda, name):
    """The autograd Function of each wrapper (the scan's forward K2 and
    backward K3; K4-K7 kernel forward + the twin's gradient) against
    autograd through the plain twin, float32, 1e-4 of each gradient's scale."""
    kern, plain, args = _cases(torch.Generator().manual_seed(2), torch.float32, 2, 40, 72, 64, 16)[name]
    scan_kernels = (scan.selective_scan_proj_states, scan.selective_scan_proj_bwd)
    before = [k.launches for k in scan_kernels]
    outs = []
    for run in (kern, plain):
        leaves = [a.detach().clone().requires_grad_(a.is_floating_point()) for a in args]
        y = run(*leaves)
        y = y if isinstance(y, tuple) else (y,)
        cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(3)).cuda() for o in y]
        wrt = [a for a in leaves if a.requires_grad]
        outs.append(torch.autograd.grad(y, wrt, cot))
    if name == "K1":  # forward K2, backward K3, once each
        assert [k.launches for k in scan_kernels] == [b + 1 for b in before]
    for g_kern, g_plain in zip(*outs):
        err, scale = _cuda.twin_error(g_kern, g_plain)
        assert err <= 1e-4 * scale, err


def test_block_at_the_k7_gate_matches_its_plain_twins(cuda):
    cfg = Config(compute_dtype="bfloat16")
    model = get_model(cfg, device=cuda)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    side = int(np.ceil(np.sqrt(LN_MSL_MIN_PIXELS)))  # 320: square, 8-aligned
    x = torch.randn(1, side, side, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
    assert block.ln_msl_supported(x)
    before = block.ln_msl.launches
    with torch.inference_mode():
        got = model.block_0(x)
        torch.cuda.synchronize()
        assert block.ln_msl.launches == before + 1
        with _cuda.force_plain():
            want = model.block_0(x)
    assert block.ln_msl.launches == before + 1
    err, scale = _cuda.twin_error(got, want)
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_small_flagship_on_cuda_matches_cpu(cuda, dtype, tol):
    cfg = Config(compute_dtype=dtype, model_kwargs=SMALL)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(2, 40, 40, 1, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda):
        model = get_model(cfg, device=dev)
        model.load_state_dict(sd)
        with torch.inference_mode():
            outs.append(model(x.to(dev)).cpu())
    assert (outs[1] - outs[0]).abs().max().item() <= tol


def _k8_case(g, dtype, B, L, D, heads):
    """q, k, v [B, L, D] and a band mask: EPIT's own at L = 160 (5 x 32
    tokens), else an 11-wide band over the sequence."""
    q, k, v = (_rn(g, B, L, D, dtype=dtype) for _ in range(3))
    if L == 160:
        mask = band_mask(5, 32, 10, 11, torch.device("cuda"))
    else:
        i = torch.arange(L)
        mask = torch.where((i[None] - i[:, None]).abs() <= 5, 0.0, float("-inf")).cuda()
    return q, k, v, mask, heads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 128, 4), (8, 32, 128, 8), (64, 160, 128, 8),
                                   (4, 40, 256, 8), (3, 37, 128, 8)],
                         ids=["hd32", "hd16", "epit", "d256", "ragged"])
def test_k8_matches_plain_twin(cuda, dtype, shape):
    args = _k8_case(torch.Generator().manual_seed(4), dtype, *shape)
    before = masked_attention.masked_mha_fused.launches
    got = masked_attention.masked_mha_fused(*args)
    torch.cuda.synchronize()
    assert masked_attention.masked_mha_fused.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    err, scale = _cuda.twin_error(got, masked_attention.masked_mha_plain(*args))
    assert err <= TOL[dtype] * scale, err


def test_k8_function_gradients_match_plain_twin(cuda):
    """K8's PlainVJP (kernel forward, the twin's gradient) against autograd
    through the twin, float32, 1e-4 of each gradient's scale."""
    args = _k8_case(torch.Generator().manual_seed(5), torch.float32, 4, 160, 128, 8)
    cot = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(6)).cuda()
    outs = []
    for run in (masked_attention.masked_mha_fused, masked_attention.masked_mha_plain):
        leaves = [a.detach().clone().requires_grad_() for a in args[:3]]
        outs.append(torch.autograd.grad(run(*leaves, *args[3:]), leaves, cot))
    for g_kern, g_plain in zip(*outs):
        err, scale = _cuda.twin_error(g_kern, g_plain)
        assert err <= 1e-4 * scale, err


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_one_block_epit_on_cuda_matches_cpu(cuda, dtype, tol):
    cfg = Config(model_name="EPIT", compute_dtype=dtype, model_kwargs={"n_blocks": 1})
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(2, 40, 40, 1, generator=torch.Generator().manual_seed(1))
    outs = []
    before = masked_attention.masked_mha_fused.launches
    for dev in ("cpu", cuda):
        model = get_model(cfg, device=dev)
        model.load_state_dict(sd)
        with torch.inference_mode():
            outs.append(model(x.to(dev)).cpu())
    assert masked_attention.masked_mha_fused.launches == before + 2  # both EPI passes, on CUDA
    err, scale = _cuda.twin_error(outs[1], outs[0])
    assert err <= tol * scale, err

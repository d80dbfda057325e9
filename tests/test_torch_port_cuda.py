"""CUDA kernels of the port against their plain twins (needs the card).

Each kernel runs on CUDA tensors and is compared with its plain PyTorch
twin on the same inputs: float32 with TF32 off to 1e-4 of the output scale
(sums in another order, ``expf``/``rsqrtf`` rounding), bfloat16 to 3e-2
(a few bf16 roundings at other places). Also: launch counters, a block at
K7's gate on the kernels vs on the plain twins, and the small flagship on
CUDA vs on the CPU.

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
from lfsr_tpu_torch.ops import _cuda, block, cross_scan, scan, window_attention
from lfsr_tpu_torch.ops.block import LN_MSL_MIN_PIXELS

pytestmark = pytest.mark.gpu

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
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
    return {
        "K1": (scan.selective_scan_proj, scan.selective_scan_proj_plain,
               (_rn(g, B, L, Di, s=0.5, dtype=dtype), _rn(g, B, L, R + 2 * N, s=0.5, dtype=dtype),
                _rn(g, R, Di, s=0.3), _rn(g, Di, s=0.1), A, torch.ones(Di, device="cuda"))),
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


@pytest.mark.parametrize("name", ["K1", "K4", "K5", "K6", "K7"])
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
    err, scale = _cuda.twin_error(got, plain(*args))
    assert err <= TOL[dtype] * scale, err


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

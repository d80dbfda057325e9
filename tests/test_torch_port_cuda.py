"""CUDA kernels of the port against their plain twins (needs the card).

Each kernel runs on CUDA tensors and is compared with its plain PyTorch
twin on the same inputs: float32 with TF32 off to 1e-4 of the output scale
(sums in another order, ``expf``/``rsqrtf`` rounding), bfloat16 to 3e-2
(a few bf16 roundings at other places; float32 outputs from bf16 inputs,
K2's states, K3's gradients and K10's output, to 1e-4 in float32 and 3e-2
from bf16 inputs), each output against its own scale. K9a, K9b and K9c read
B and C (and z, xs) at the row strides the model gives them (slices of dbc
and of in_proj's output), also at an L that is not a multiple of 64; K10
(the HLFR tail) runs on the last stage's map at twice the block's side and
at an odd size. Also: launch counters, K2's y equal to K1's bit for bit,
the gradients of the autograd Functions (the scan's K2 + K3, and the
PlainVJPs of K4-K8, K9a and K10) on the kernels vs on the twins, a block at
K7's gate and a block under each of ``scan_impl='gated'``/``'fused'`` on
the kernels vs on the plain twins, the small flagship (K10 once) and a
one-block EPIT on CUDA vs on the CPU. K1 and K2 (the chunk-parallel scan)
at lengths around their chunk length, K3 (the chunk-parallel reverse scan)
around its chunk of 64 steps and at odd widths, two of its calls bit-equal,
K8's tensor-core kernel at several lengths and head dims with band and
random -inf masks, and which K8 kernel each dtype and head dim takes. K6's
two kernels by shape (the tensor-core one at the flagship's head dim 16 and
at 8, the CUDA-core one at 4 and 18), two of its calls bit-equal. The scans
at d_state 24 (V7's default): K1, K2 and K3 at every length case beside
4-32, and K1, K2, K3, K9a, K9b and K9c at V7's widths (Di 90, dt rank 5)
and at an odd one (Di 37, rank 3). K7's tensor-core kernel with x in bf16
and in float32 (its float32-input mode) and K5's, at 1 x 17 x 23, the
tiled, Real and 644 x 644 maps and C 16 to 128, K7's taps bit-equal to the
twin's on its own xn, both CUDA-core kernels, each call's ``launches/K<n>/<path>``,
and a block below the TPU's gate on K7's float32-input mode. K4's tile
kernel in bf16 and float32 at C 16-128 on the 1 x 17 x 23, tiled, Real and
Synth maps, its one-warp kernel at the other widths, and their
``launches/K4/<path>``; K10 at every width it takes, in both dtypes, on
maps around its tiles; two calls of each bit-equal, and K10's output
unchanged, bit for bit, when a crop moves its tile boundaries.

This file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Here (no CUDA device) every test skips.
"""

import numpy as np
import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.models.epit import band_mask
from lfsr_tpu_torch.models.lfmambax import fold_out_conv
from lfsr_tpu_torch.ops import (
    _cuda, block, cross_scan, head, masked_attention, scan, window_attention,
)
from lfsr_tpu_torch.ops.block import LN_MSL_MIN_PIXELS

from _torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
# by output dtype: a float32 output (K2's states, K3's gradients) from bf16
# inputs is computed in float32 on both sides; K10's float32 output is not
# (both sides round z to bf16), so it goes by its input dtype
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
        # delta before softplus, D given; chunk 64 (the gradient's chunked
        # scan needs L % chunk == 0: 40 x 72 = 45 x 64)
        "K9a": (scan.selective_scan_fused, scan.selective_scan_fused_plain,
                (_rn(g, B, L, Di, s=0.5, dtype=dtype), _rn(g, B, L, Di, s=0.5, dtype=dtype), A,
                 dbc[..., R : R + N], dbc[..., R + N :], 1 + _rn(g, Di, s=0.1), 64, True)),
        # the HLFR tail on the last stage's [B, 2H, 2W, C] map, rr 4
        "K10": (head.hlfr_tail, head.hlfr_tail_plain,
                (_rn(g, B, 2 * H, 2 * W, C, dtype=dtype), _rn(g, C, 4 * C, s=C**-0.5, dtype=dtype),
                 fold_out_conv(_rn(g, 3, 3, C, 1, s=0.1, dtype=dtype), 2),
                 _rn(g, 1, s=0.1, dtype=dtype))),
        "K9b": (scan.scan_gated_fused, scan.scan_gated_plain,
                (_rn(g, B, L, Di, s=0.5, dtype=dtype), _rn(g, B, L, Di, s=0.5, dtype=dtype), A,
                 dbc[..., R : R + N], dbc[..., R + N :], xz[..., Di:],
                 torch.ones(Di, device="cuda"), _rn(g, Di, C, s=Di**-0.5, dtype=dtype), True)),
        "K9c": (scan.mamba_inner_fused, scan.mamba_inner_plain,
                (xz[..., :Di], xz[..., Di:], _rn(g, 4, Di, s=0.3), _rn(g, Di, s=0.1),
                 _rn(g, Di, R + 2 * N, s=Di**-0.5), _rn(g, R, Di, s=0.3), _rn(g, Di, s=0.1), A,
                 torch.ones(Di, device="cuda"))),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K9a", "K9b", "K9c",
                                  "K10"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 4), (2, 160, 160, 64, 16),
                                   (2, 40, 72, 64, 16)],
                         ids=["small", "flagship", "non_square"])
def test_kernel_matches_plain_twin(cuda, name, dtype, shape):
    B, H, W, C, N = shape  # batch, map height and width, channels, d_state
    kern, plain, args = _cases(torch.Generator().manual_seed(0), dtype, B, H, W, C, N)[name]
    before = trace.counter(f"launches/{kern.kernel}")
    got = kern(*args)
    torch.cuda.synchronize()
    assert trace.counter(f"launches/{kern.kernel}") == before + 1
    want = plain(*args)
    for a, b in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        err, scale = _cuda.twin_error(a, b)
        # K10's float32 output comes from z rounded to the input's dtype
        assert err <= TOL[dtype if name == "K10" else a.dtype] * scale, err


@pytest.mark.parametrize("name", ["K9a", "K9b", "K9c"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_at_a_ragged_length_matches_plain_twin(cuda, name, dtype):
    """L = 25 x 39 = 975, a multiple of neither 64 nor 128 (the TPU pads;
    the kernels take any L)."""
    kern, plain, args = _cases(torch.Generator().manual_seed(7), dtype, 2, 25, 39, 64, 16)[name]
    got = kern(*args)
    torch.cuda.synchronize()
    err, scale = _cuda.twin_error(got, plain(*args))
    assert got.dtype == dtype and err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10_at_an_odd_size_matches_plain_twin(cuda, dtype):
    """y [1, 37, 53, 64]: neither side a multiple of the kernel's 16-pixel
    tile, so its halo and its last tiles run past the image's edges."""
    g = torch.Generator().manual_seed(8)
    args = (_rn(g, 1, 37, 53, 64, dtype=dtype), _rn(g, 64, 256, s=0.125, dtype=dtype),
            fold_out_conv(_rn(g, 3, 3, 64, 1, s=0.1, dtype=dtype), 2), _rn(g, 1, s=0.1, dtype=dtype))
    before = trace.counter("launches/K10")
    got = head.hlfr_tail(*args)
    torch.cuda.synchronize()
    assert trace.counter("launches/K10") == before + 1
    assert got.dtype == torch.float32 and got.shape == (1, 37, 53, 4)
    err, scale = _cuda.twin_error(got, head.hlfr_tail_plain(*args))
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("impl", ["gated", "fused"])
def test_block_under_each_scan_impl_matches_its_plain_twins(cuda, impl):
    cfg = Config(compute_dtype="bfloat16", model_kwargs={"scan_impl": impl})
    model = get_model(cfg, device=cuda)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.randn(2, 40, 72, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
    kern = {"gated": scan.scan_gated_fused, "fused": scan.mamba_inner_fused}[impl]
    before = (trace.counter(f"launches/{kern.kernel}"), trace.counter("launches/K1"))
    with torch.inference_mode():
        got = model.block_0(x)
        torch.cuda.synchronize()
        with _cuda.force_plain():
            want = model.block_0(x)
    assert (trace.counter(f"launches/{kern.kernel}"), trace.counter("launches/K1")) == (
        before[0] + 1, before[1])
    err, scale = _cuda.twin_error(got, want)
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_y_equals_k1_y(cuda, dtype):
    args = _cases(torch.Generator().manual_seed(1), dtype, 2, 40, 72, 64, 16)["K1"][2]
    y, states = scan.selective_scan_proj_states(*args)
    assert torch.equal(y, scan.selective_scan_proj(*args))
    assert states.dtype == torch.float32 and states.shape == (2, -(-40 * 72 // 64), 16, 80)


@pytest.mark.parametrize("name", ["K1", "K4", "K5", "K6", "K7", "K9a", "K10"])
def test_function_gradients_match_plain_twin(cuda, name):
    """The autograd Function of each wrapper (the scan's forward K2 and
    backward K3; K4-K7, K9a and K10 kernel forward + the twin's gradient)
    against autograd through the plain twin, float32, 1e-4 of each
    gradient's scale."""
    kern, plain, args = _cases(torch.Generator().manual_seed(2), torch.float32, 2, 40, 72, 64, 16)[name]
    scan_kernels = (scan.selective_scan_proj_states, scan.selective_scan_proj_bwd)
    before = [trace.counter(f"launches/{k.kernel}") for k in scan_kernels]
    outs = []
    for run in (kern, plain):
        leaves = [a.detach().clone().requires_grad_(a.is_floating_point())
                  if isinstance(a, torch.Tensor) else a for a in args]
        y = run(*leaves)
        y = y if isinstance(y, tuple) else (y,)
        cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(3)).cuda() for o in y]
        wrt = [a for a in leaves if isinstance(a, torch.Tensor) and a.requires_grad]
        outs.append(torch.autograd.grad(y, wrt, cot))
    if name == "K1":  # forward K2, backward K3, once each
        got = [trace.counter(f"launches/{k.kernel}") for k in scan_kernels]
        assert got == [b + 1 for b in before]
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
    before = trace.counter("launches/K7")
    with torch.inference_mode():
        got = model.block_0(x)
        torch.cuda.synchronize()
        assert trace.counter("launches/K7") == before + 1
        with _cuda.force_plain():
            want = model.block_0(x)
    assert trace.counter("launches/K7") == before + 1
    err, scale = _cuda.twin_error(got, want)
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_small_flagship_on_cuda_matches_cpu(cuda, dtype, tol):
    cfg = Config(compute_dtype=dtype, model_kwargs=SMALL)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(2, 40, 40, 1, generator=torch.Generator().manual_seed(1))
    outs = []
    before = trace.counter("launches/K10")
    for dev in ("cpu", cuda):
        model = get_model(cfg, device=dev)
        model.load_state_dict(sd)
        with torch.inference_mode():
            outs.append(model(x.to(dev)).cpu())
    assert trace.counter("launches/K10") == before + 1  # the tail, on CUDA only
    assert (outs[1] - outs[0]).abs().max().item() <= tol


def test_spans_time_the_small_flagship_on_the_stream(cuda):
    """Under the profiler a forward on the card records each kernel
    wrapper's span with event-timed device milliseconds, and each block's
    self time is the block less the kernel spans in it."""
    from torch.profiler import ProfilerActivity, profile

    cfg = Config(compute_dtype="bfloat16", model_kwargs=SMALL)
    model = get_model(cfg, device=cuda)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.rand(2, 40, 40, 1, device=cuda)
    with torch.inference_mode():
        model(x)  # warm-up: the library's build and load
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            model(x)
            torch.cuda.synchronize()
    s = trace.summary()["spans"]
    assert {k: s[k]["calls"] for k in ("K1", "K4", "K5", "K7", "K6", "K10", "model.block")} == {
        "K1": 3, "K4": 3, "K5": 3, "K7": 3, "K6": 1, "K10": 1, "model.block": 3}
    assert all(v["device_ms"] > 0 for v in s.values())
    blk = s["model.block"]
    inner = s["K7"]["device_ms"] + s["model.block.ssm"]["device_ms"]
    assert blk["device_self_ms"] == pytest.approx(blk["device_ms"] - inner, rel=1e-6, abs=1e-6)


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
    before = trace.counter("launches/K8")
    got = masked_attention.masked_mha_fused(*args)
    torch.cuda.synchronize()
    assert trace.counter("launches/K8") == before + 1
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
    before = trace.counter("launches/K8")
    for dev in ("cpu", cuda):
        model = get_model(cfg, device=dev)
        model.load_state_dict(sd)
        with torch.inference_mode():
            outs.append(model(x.to(dev)).cpu())
    assert trace.counter("launches/K8") == before + 2  # both EPI passes, on CUDA
    err, scale = _cuda.twin_error(outs[1], outs[0])
    assert err <= tol * scale, err


# ---- K1 / K2: the chunk-parallel scan around its chunk boundaries ----------

def _scan_operands(g, dtype, B, L, N, Di=80, R=4):
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(Di, 1).cuda()
    return (_rn(g, B, L, Di, s=0.5, dtype=dtype), _rn(g, B, L, R + 2 * N, s=0.5, dtype=dtype),
            _rn(g, R, Di, s=0.3), _rn(g, Di, s=0.1), A, 1 + _rn(g, Di, s=0.1))


def _scan_length(B, which):
    """L for the case ``which``: a number, or one relative to the chunk
    length Tc the scan takes at (B, 25600)."""
    tc = scan.scan_chunk_len(B, 25600)
    return {"Tc-1": tc - 1, "Tc": tc, "Tc+1": tc + 1, "3Tc+17": 3 * tc + 17}.get(which, which)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [4, 8, 16, 24, 32])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("L", [1, 63, 64, 65, "Tc-1", "Tc", "Tc+1", "3Tc+17", 25600])
def test_k1_k2_chunked_match_twins_and_each_other(cuda, L, B, N, dtype):
    """K1 and K2 against their twins (y, and K2's states, each to its own
    scale), and K2's y equal to K1's bit for bit."""
    L = _scan_length(B, L)
    args = _scan_operands(torch.Generator().manual_seed(9), dtype, B, L, N)
    before = (trace.counter("launches/K1"), trace.counter("launches/K2"))
    y1 = scan.selective_scan_proj(*args)
    y2, states = scan.selective_scan_proj_states(*args)
    torch.cuda.synchronize()
    assert (trace.counter("launches/K1"), trace.counter("launches/K2")) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(y1, y2)
    want_y, want_states = scan.selective_scan_proj_states_plain(*args)
    for got, want in ((y1, want_y), (states, want_states)):
        assert got.dtype == want.dtype and got.shape == want.shape
        err, scale = _cuda.twin_error(got, want)
        assert err <= TOL[got.dtype] * scale, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Di,R", [(37, 3), (300, 5)])
@pytest.mark.parametrize("L", [65, "3Tc+17"])
def test_k1_k2_chunked_at_odd_widths(cuda, L, Di, R, dtype):
    """K1 and K2 where a staged u row is not whole 16-byte granules (37
    channels) or the channels take two CTAs, the second part-filled (300
    at 2 lanes each), with an odd dbc row: against their twins, and K2's y
    equal to K1's bit for bit."""
    L = _scan_length(3, L)
    args = _scan_operands(torch.Generator().manual_seed(10), dtype, 3, L, 16, Di, R)
    y1 = scan.selective_scan_proj(*args)
    y2, states = scan.selective_scan_proj_states(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    for got, want in zip((y1, states), scan.selective_scan_proj_states_plain(*args)):
        err, scale = _cuda.twin_error(got, want)
        assert err <= TOL[got.dtype] * scale, err


# ---- K3: the chunk-parallel reverse scan around its chunk boundaries -------

def _k3_operands(g, dtype, B, L, N, Di=80, R=4):
    """K3's operands: the scan's, a cotangent dy, and K2's saved states."""
    u, dbc, Wdt, bdt, A, D = _scan_operands(g, dtype, B, L, N, Di, R)
    states = scan.selective_scan_proj_states(u, dbc, Wdt, bdt, A, D)[1]
    return u, dbc, _rn(g, B, L, Di, dtype=dtype), Wdt, bdt, A, states


def _check_k3(args):
    before = trace.counter("launches/K3")
    got = scan.selective_scan_proj_bwd(*args)
    torch.cuda.synchronize()
    assert trace.counter("launches/K3") == before + 1
    for a, b in zip(got, scan.selective_scan_proj_bwd_plain(*args)):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        err, scale = _cuda.twin_error(a, b)
        assert err <= 1e-4 * scale, err
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [4, 8, 16, 24, 32])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 975, 4161])
def test_k3_chunked_matches_twin(cuda, L, B, N, dtype):
    """K3 (summaries, carry, adjoint, sum of dA; the adjoint alone at
    L <= 64) against its twin, each of its five float32 outputs to 1e-4 of
    its own scale, at lengths around its chunk of 64 steps."""
    _check_k3(_k3_operands(torch.Generator().manual_seed(11), dtype, B, L, N))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [4, 16, 32])
@pytest.mark.parametrize("Di,R", [(37, 3), (300, 5)])
@pytest.mark.parametrize("L", [65, 4161])
def test_k3_chunked_at_odd_widths(cuda, L, Di, R, N, dtype):
    """K3 where the last channel group of a chunk is part-filled (37
    channels) or a chunk walks many groups (300), with an odd dbc row."""
    _check_k3(_k3_operands(torch.Generator().manual_seed(12), dtype, 3, L, N, Di, R))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Di", [80, 300])
def test_k3_two_calls_give_the_same_bits(cuda, Di, dtype):
    """No atomics: dB/dC summed over channel groups and dA over chunks in a
    fixed order, so two calls on the same inputs agree bit for bit."""
    args = _k3_operands(torch.Generator().manual_seed(13), dtype, 3, 4161, 16, Di, 5)
    first = scan.selective_scan_proj_bwd(*args)
    second = scan.selective_scan_proj_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ---- K8: the tensor-core kernel and the dispatch ---------------------------

def _k8_mask(g, L, kind):
    """EPIT's band mask where L = 5 h, else an 11-wide band; or ("random")
    -inf at ~30% of the entries and small values elsewhere, the diagonal
    kept, and row 1 -inf everywhere (its output is NaN, as the twin's)."""
    if kind == "band":
        if L % 5 == 0:
            return band_mask(5, L // 5, 10, 11, torch.device("cuda"))
        i = torch.arange(L)
        return torch.where((i[None] - i[:, None]).abs() <= 5, 0.0, float("-inf")).cuda()
    m = torch.randn(L, L, generator=g) * 0.5
    m = torch.where(torch.rand(L, L, generator=g) < 0.3, float("-inf"), m)
    m.fill_diagonal_(0.0)
    m[1] = float("-inf")
    return m.cuda()


@pytest.mark.parametrize("kind", ["band", "random"])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("L", [8, 40, 72, 160, 168])
def test_k8_tensor_core_kernel_matches_plain_twin(cuda, L, hd, kind):
    g = torch.Generator().manual_seed(11)
    q, k, v = (_rn(g, 6, L, 128, dtype=torch.bfloat16) for _ in range(3))
    mask, heads = _k8_mask(g, L, kind), 128 // hd
    assert masked_attention.kernel_path(torch.bfloat16, hd) == "mma"
    before = trace.counts("launches/K8/")
    got = masked_attention.masked_mha_fused(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert trace.counts("launches/K8/") == {"mma": before["mma"] + 1, "fma": before["fma"]}
    want = masked_attention.masked_mha_plain(q, k, v, mask, heads)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert nan.any() == (kind == "random")
    err, scale = _cuda.twin_error(got[~nan], want[~nan])
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 16), (torch.float32, 64),
                                      (torch.bfloat16, 8)])
def test_k8_float32_and_head_dim_8_take_the_cuda_core_kernel(cuda, dtype, hd):
    g = torch.Generator().manual_seed(12)
    q, k, v = (_rn(g, 4, 40, 128, dtype=dtype) for _ in range(3))
    mask = _k8_mask(g, 40, "band")
    assert masked_attention.kernel_path(dtype, hd) == "fma"
    before = trace.counts("launches/K8/")
    got = masked_attention.masked_mha_fused(q, k, v, mask, 128 // hd)
    torch.cuda.synchronize()
    assert trace.counts("launches/K8/") == {"mma": before["mma"], "fma": before["fma"] + 1}
    err, scale = _cuda.twin_error(got, masked_attention.masked_mha_plain(q, k, v, mask, 128 // hd))
    assert err <= TOL[dtype] * scale, err


# ---- K6: the two kernels by shape -------------------------------------------

def _k6_args(g, dtype, B, H, W, C, heads, scale=0.25):
    return (_rn(g, B, H, W, C, dtype=dtype), _rn(g, C, 3 * C, s=C**-0.5), _rn(g, C, C, s=C**-0.5),
            1 + _rn(g, C, s=0.2), _rn(g, C, s=0.1), _rn(g, 64, heads * 64, s=0.02),
            torch.full((1,), scale, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,path", [
    ((2, 160, 160, 64, 4), "mma"), ((8, 160, 160, 64, 4), "mma"), ((1, 40, 72, 64, 4), "mma"),
    ((1, 720, 720, 64, 4), "mma"), ((3, 24, 40, 32, 4), "mma"), ((1, 16, 24, 88, 11), "mma"),
    ((1, 16, 16, 16, 4), "fma"), ((2, 40, 40, 72, 4), "fma")],
    ids=["tiled", "train", "non_square", "synth_row", "hd8", "c88", "small_hd4", "v8_hd18"])
@pytest.mark.parametrize("attn_scale", [0.25, 1.0])
def test_k6_takes_its_kernel_by_shape_and_holds_its_twin(cuda, dtype, shape, path, attn_scale):
    """The flagship's shapes (head dim 16, float32 and bfloat16) and head dim
    8 on the tensor cores; head dims 4 and 18 on the CUDA cores; float32 to
    1e-4 of scale, also at attn_scale 1 where one TF32 product would miss."""
    B, H, W, C, heads = shape
    args = _k6_args(torch.Generator().manual_seed(14), dtype, B, H, W, C, heads, attn_scale)
    assert window_attention.kernel_path(C, heads, 8) == path
    before = trace.counts("launches/K6/")
    got = window_attention.window_mha_fused(*args, 8, heads, 1e-6)
    torch.cuda.synchronize()
    assert trace.counts("launches/K6/") == {k: v + (k == path) for k, v in before.items()}
    want = window_attention.window_mha_plain(*args, 8, heads, 1e-6)
    assert got.dtype == dtype and got.shape == want.shape
    err, scale = _cuda.twin_error(got, want)
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_two_calls_give_the_same_bits(cuda, dtype):
    args = _k6_args(torch.Generator().manual_seed(15), dtype, 4, 160, 240, 64, 4)
    first = window_attention.window_mha_fused(*args)
    second = window_attention.window_mha_fused(*args)
    assert torch.equal(first, second)


# ---- the scans at d_state 24 ------------------------------------------------

def _n24_cases(g, dtype, B, L, Di, R, N=24):
    """K1, K2, K3, K9a, K9b and K9c at d_state N with Di channels and dt
    rank R, B and C (and z, xs) at the model's row strides."""
    u, dbc, Wdt, bdt, A, D = _scan_operands(g, dtype, B, L, N, Di, R)
    with torch.no_grad():
        states = scan.selective_scan_proj_states(u, dbc, Wdt, bdt, A, D)[1]
    xz = _rn(g, B, L, 2 * Di, dtype=dtype)
    Bc, Cc = dbc[..., R : R + N], dbc[..., R + N :]
    return {
        "K1": (scan.selective_scan_proj, scan.selective_scan_proj_plain, (u, dbc, Wdt, bdt, A, D)),
        "K2": (scan.selective_scan_proj_states, scan.selective_scan_proj_states_plain,
               (u, dbc, Wdt, bdt, A, D)),
        "K3": (scan.selective_scan_proj_bwd, scan.selective_scan_proj_bwd_plain,
               (u, dbc, _rn(g, B, L, Di, dtype=dtype), Wdt, bdt, A, states)),
        "K9a": (scan.selective_scan_fused, scan.selective_scan_fused_plain,
                (u, _rn(g, B, L, Di, s=0.5, dtype=dtype), A, Bc, Cc, D, 64, True)),
        "K9b": (scan.scan_gated_fused, scan.scan_gated_plain,
                (u, _rn(g, B, L, Di, s=0.5, dtype=dtype), A, Bc, Cc, xz[..., Di:], D,
                 _rn(g, Di, 72, s=Di**-0.5, dtype=dtype), True)),
        "K9c": (scan.mamba_inner_fused, scan.mamba_inner_plain,
                (xz[..., :Di], xz[..., Di:], _rn(g, 4, Di, s=0.3), _rn(g, Di, s=0.1),
                 _rn(g, Di, R + 2 * N, s=Di**-0.5), Wdt, bdt, A, D)),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K9a", "K9b", "K9c"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Di,R,L", [(90, 5, 4160), (90, 5, 25600), (37, 3, 975)],
                         ids=["v7", "v7_train", "odd"])
def test_scans_at_d_state_24_match_their_twins(cuda, name, dtype, Di, R, L):
    """Each output to its own scale (float32 outputs of K2 and K3 to 1e-4);
    K2's y equal to K1's bit for bit."""
    kern, plain, args = _n24_cases(torch.Generator().manual_seed(16), dtype, 2, L, Di, R)[name]
    before = trace.counter(f"launches/{kern.kernel}")
    got = kern(*args)
    torch.cuda.synchronize()
    assert trace.counter(f"launches/{kern.kernel}") == before + 1
    if name == "K2":
        assert torch.equal(got[0], scan.selective_scan_proj(*args))
    want = plain(*args)
    for a, b in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert a.dtype == b.dtype and a.shape == b.shape
        err, scale = _cuda.twin_error(a, b)
        assert err <= TOL[a.dtype] * scale, err


@pytest.mark.parametrize("N", [12, 20, 64])
def test_scans_refuse_a_d_state_outside_the_set(cuda, N):
    kern, _, args = _n24_cases(torch.Generator().manual_seed(17), torch.float32, 1, 64, 16, 2,
                               N=16)["K1"]
    u, dbc, Wdt, bdt, A, D = args
    dbc = _rn(torch.Generator().manual_seed(18), 1, 64, 2 + 2 * N)
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(16, 1).cuda()
    with pytest.raises(ValueError, match=r"\(4, 8, 16, 24, 32\)"):
        kern(u, dbc, Wdt, bdt, A, D)


# ---- K7 and K5 on the tensor cores, and their CUDA-core paths ----------------

K57_SHAPES = [(1, 17, 23), (2, 160, 160), (4, 640, 880), (4, 644, 644)]
K57_IDS = ["1x17x23", "tiled", "real", "644"]


def _rc(g, *shape, s=1.0, dtype=torch.float32):
    """Normal values made on the card (the larger maps are ~1 GB)."""
    return (torch.randn(*shape, generator=g, device="cuda") * s).to(dtype)


def _k7_args(g, x_dtype, w_dtype, B, H, W, C):
    c4 = C // 4
    return (_rc(g, B, H, W, C, dtype=x_dtype), 1 + _rc(g, C, s=0.2), _rc(g, C, s=0.1),
            _rc(g, c4, C, s=C**-0.5, dtype=w_dtype), _rc(g, C - c4, C, s=C**-0.5, dtype=w_dtype),
            _rc(g, 3, 3, C - c4, s=0.3, dtype=w_dtype))


@pytest.mark.parametrize("C", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", K57_SHAPES, ids=K57_IDS)
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_input", "f32_input"])
def test_k7_mma_holds_its_twin(cuda, x_dtype, shape, C):
    """bf16 weights take the tensor-core kernel with x in bf16 (the TPU's
    gate) or float32 (the float32-input mode), at ragged, tiled, Real and
    non-8-aligned maps and C 16 to 128 (c4 = C / 4: 4, 8, 16, 32)."""
    g = torch.Generator(device="cuda").manual_seed(20 + C)
    args = _k7_args(g, x_dtype, torch.bfloat16, *shape, C)
    before = trace.counts("launches/K7/")
    got = block.ln_msl(*args)
    torch.cuda.synchronize()
    assert trace.counts("launches/K7/") == {"mma": before["mma"] + 1, "fma": before["fma"]}
    want = block.ln_msl_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        err, scale = _cuda.twin_error(a, b)
        assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_input", "f32_input"])
@pytest.mark.parametrize("shape,C", [((2, 160, 160), 64), ((1, 17, 23), 32), ((1, 40, 72), 48)],
                         ids=["tiled", "ragged", "c48"])
def test_k7_taps_equal_the_twins_bit_for_bit(cuda, x_dtype, shape, C):
    """The kernel's 9 taps (bf16x2 multiply, add, each rounded once) against
    the twin's on the kernel's own xn: with whm 0 and wrest 64 times the
    identity (rest channel j to output channel c4 + j) both products are
    exact, so local = round(lrelu(64 rest) + xn) must equal the twin's
    bit for bit (64 rest sets the sum's exponent, so a tap an ulp off would
    show)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x, gamma, beta, _, _, wk = _k7_args(g, x_dtype, torch.bfloat16, *shape, C)
    c4 = C // 4
    whm = torch.zeros(c4, C, dtype=torch.bfloat16, device="cuda")
    wrest = torch.zeros(C - c4, C, dtype=torch.bfloat16, device="cuda")
    wrest[:, c4:] = 64 * torch.eye(C - c4, dtype=torch.bfloat16, device="cuda")
    xn, local = block.ln_msl(x, gamma, beta, whm, wrest, wk)
    torch.cuda.synchronize()
    assert torch.equal(local, block.msl_plain(xn, whm, wrest, wk))


@pytest.mark.parametrize("shape", [(1, 17, 23), (2, 160, 160), (2, 40, 72)],
                         ids=["ragged", "tiled", "non_square"])
def test_k7_f32_takes_the_cuda_core_kernel(cuda, shape):
    g = torch.Generator(device="cuda").manual_seed(8)
    args = _k7_args(g, torch.float32, torch.float32, *shape, 64)
    before = trace.counts("launches/K7/")
    got = block.ln_msl(*args)
    torch.cuda.synchronize()
    assert trace.counts("launches/K7/") == {"mma": before["mma"], "fma": before["fma"] + 1}
    for a, b in zip(got, block.ln_msl_plain(*args)):
        assert a.dtype == torch.float32
        err, scale = _cuda.twin_error(a, b)
        assert err <= TOL[torch.float32] * scale, err


def test_k7_refuses_bf16_x_with_float32_weights(cuda):
    args = _k7_args(torch.Generator(device="cuda").manual_seed(9), torch.bfloat16,
                    torch.float32, 1, 16, 16, 64)
    with pytest.raises(ValueError, match="float32-input"):
        block.ln_msl(*args)


def _k5_args(g, dtype, B, H, W, C):
    return (_rc(g, B, H * W, C, dtype=dtype), _rc(g, B, H, W, C, dtype=dtype),
            _rc(g, C, C, s=C**-0.5, dtype=dtype), torch.full((1,), 0.15, device="cuda"))


@pytest.mark.parametrize("C", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", K57_SHAPES, ids=K57_IDS)
def test_k5_mma_holds_its_twin(cuda, shape, C):
    """bf16 at C a multiple of 16 takes the tensor-core kernel (2-D tiles,
    the permutation in the copy's addresses), ragged edges and H != W
    masked; y stays float32 there, the twin rounds it (3e-2 of scale)."""
    args = _k5_args(torch.Generator(device="cuda").manual_seed(30 + C), torch.bfloat16,
                    *shape, C)
    before = trace.counts("launches/K5/")
    got = cross_scan.cross_scan_scatter(*args)
    torch.cuda.synchronize()
    assert trace.counts("launches/K5/") == {"mma": before["mma"] + 1, "fma": before["fma"]}
    err, scale = _cuda.twin_error(got, cross_scan.cross_scan_scatter_plain(*args))
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("dtype,C", [(torch.float32, 64), (torch.float32, 16),
                                     (torch.bfloat16, 20), (torch.bfloat16, 36)])
@pytest.mark.parametrize("shape", [(1, 17, 23), (2, 40, 72)], ids=["ragged", "non_square"])
def test_k5_cuda_core_kernel_takes_the_rest(cuda, dtype, C, shape):
    args = _k5_args(torch.Generator(device="cuda").manual_seed(31), dtype, *shape, C)
    before = trace.counts("launches/K5/")
    got = cross_scan.cross_scan_scatter(*args)
    torch.cuda.synchronize()
    assert trace.counts("launches/K5/") == {"mma": before["mma"], "fma": before["fma"] + 1}
    err, scale = _cuda.twin_error(got, cross_scan.cross_scan_scatter_plain(*args))
    assert err <= TOL[dtype] * scale, err


def test_block_below_the_k7_gate_takes_k7_on_float32_x(cuda):
    """A block on a map below the TPU's gate (a non-square tiled-size map)
    runs K7 in its float32-input mode, on the tensor cores, and holds its
    plain twins."""
    cfg = Config(compute_dtype="bfloat16")
    model = get_model(cfg, device=cuda)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.randn(2, 40, 72, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
    assert not block.ln_msl_supported(x)
    before = trace.counts("launches/K7/")
    with torch.inference_mode():
        got = model.block_0(x)
        torch.cuda.synchronize()
        with _cuda.force_plain():
            want = model.block_0(x)
    assert trace.counts("launches/K7/") == {"mma": before["mma"] + 1, "fma": before["fma"]}
    err, scale = _cuda.twin_error(got, want)
    assert err <= TOL[torch.bfloat16] * scale, err


# ---- K4's tile kernel and K10's halo-pipelined tensor-core kernel ----------

K4_SHAPES = [(1, 17, 23), (2, 160, 160), (4, 640, 880), (4, 720, 720)]
K4_IDS = ["1x17x23", "tiled", "real", "synth"]
# K4's float32 bound: the kernel and the twin take the same float32
# statistics in another order (and rsqrtf), ~1e-6 of the output's scale
K4_F32_TOL = 1e-5


def _k4_args(g, dtype, B, H, W, C):
    return _rc(g, B, H, W, C, dtype=dtype), 1 + _rc(g, C, s=0.2), _rc(g, C, s=0.1)


@pytest.mark.parametrize("C", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", K4_SHAPES, ids=K4_IDS)
def test_k4_tile_holds_its_twin(cuda, shape, dtype, C):
    """A quarter of a multiple of 8 bytes takes the tile kernel (16- or
    8-byte copies, ragged last tiles, H != W); bf16 within 3e-2 of scale
    (both sides take float32 statistics and round once: an ulp apart at
    most), float32 within 1e-5."""
    args = _k4_args(torch.Generator(device="cuda").manual_seed(40 + C), dtype, *shape, C)
    assert cross_scan.gather_path(dtype, C) == "tile"
    before = trace.counts("launches/K4/")
    got = cross_scan.cross_scan_gather(*args)
    torch.cuda.synchronize()
    assert trace.counts("launches/K4/") == {"tile": before["tile"] + 1, "warp": before["warp"]}
    want = cross_scan.cross_scan_gather_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    err, scale = _cuda.twin_error(got, want)
    assert err <= (TOL[dtype] if dtype == torch.bfloat16 else K4_F32_TOL) * scale, err


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 4), (torch.bfloat16, 12),
                                     (torch.bfloat16, 40), (torch.float32, 4),
                                     (torch.float32, 20)])
def test_k4_warp_kernel_takes_the_rest(cuda, dtype, C):
    """A quarter that is not a multiple of 8 bytes takes the one-warp kernel."""
    args = _k4_args(torch.Generator(device="cuda").manual_seed(41), dtype, 2, 40, 72, C)
    assert cross_scan.gather_path(dtype, C) == "warp"
    before = trace.counts("launches/K4/")
    got = cross_scan.cross_scan_gather(*args)
    torch.cuda.synchronize()
    assert trace.counts("launches/K4/") == {"tile": before["tile"], "warp": before["warp"] + 1}
    err, scale = _cuda.twin_error(got, cross_scan.cross_scan_gather_plain(*args))
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k4_tile_two_calls_give_the_same_bits(cuda, dtype):
    args = _k4_args(torch.Generator(device="cuda").manual_seed(42), dtype, 4, 160, 240, 64)
    assert torch.equal(cross_scan.cross_scan_gather(*args), cross_scan.cross_scan_gather(*args))


def _k10_args(g, dtype, B, H, W, C):
    """y [B, H, W, C], w1 [C, 4 C], kf folded from a 3x3 kernel, bias [1]."""
    return (_rc(g, B, H, W, C, dtype=dtype), _rc(g, C, 4 * C, s=C**-0.5, dtype=dtype),
            fold_out_conv(_rc(g, 3, 3, C, 1, s=0.1, dtype=dtype), 2), _rc(g, 1, s=0.1, dtype=dtype))


@pytest.mark.parametrize("C", head.TAIL_CHANNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 37, 53), (1, 16, 30), (2, 17, 31), (3, 1, 1)],
                         ids=["37x53", "one_tile", "17x31", "1x1"])
def test_k10_holds_its_twin_at_each_width(cuda, shape, dtype, C):
    """Each kernel (bf16: 16 x 30 tiles, float32: 16 x 16) at every width
    the wrapper takes, Cz = 4 C, on maps that are a tile, one pixel more
    than a tile each way, neither, or a single pixel (all halo)."""
    args = _k10_args(torch.Generator(device="cuda").manual_seed(50 + C), dtype, *shape, C)
    before = trace.counter("launches/K10")
    got = head.hlfr_tail(*args)
    torch.cuda.synchronize()
    assert trace.counter("launches/K10") == before + 1
    assert got.dtype == torch.float32 and got.shape == (*shape, 4)
    err, scale = _cuda.twin_error(got, head.hlfr_tail_plain(*args))
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k10_two_calls_give_the_same_bits(cuda, dtype):
    args = _k10_args(torch.Generator(device="cuda").manual_seed(51), dtype, 2, 320, 320, 64)
    assert torch.equal(head.hlfr_tail(*args), head.hlfr_tail(*args))


@pytest.mark.parametrize("dy,dx", [(5, 7), (16, 30), (1, 29)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k10_tile_placement_changes_no_bit(cuda, dtype, dy, dx):
    """A pixel's output is a function of its 3 x 3 neighbourhood of y alone,
    summed in a fixed order: cropping y's top and left moves every tile
    boundary, and changes no bit of an output whose neighbourhood the crop
    keeps (all but its first row and column)."""
    y, *rest = _k10_args(torch.Generator(device="cuda").manual_seed(52), dtype, 1, 70, 97, 64)
    full = head.hlfr_tail(y, *rest)
    crop = head.hlfr_tail(y[:, dy:, dx:].contiguous(), *rest)
    assert torch.equal(crop[:, 1:, 1:], full[:, dy + 1 :, dx + 1 :])

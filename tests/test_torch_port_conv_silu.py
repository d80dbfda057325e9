"""K14 (``ops/scan.py``: the Mamba's causal conv + SiLU) on the CPU, where
the wrapper runs its plain twin, the chain ``conv_silu``.

- The wrapper on CPU tensors is ``conv_silu`` in xs's dtype, bit for bit, in
  float32 and bfloat16, with xs as the first half of in_proj's output xz
  and as a contiguous tensor; at Di 20 and 80, K 1-4 and L shorter than K;
  it counts nothing.
- With a gradient wanted (``_cuda.PlainVJP``) its gradients are autograd's
  through the chain, bit for bit.
- ``Mamba.forward`` with no gradient wanted goes through the wrapper under
  ``'pallas'`` and ``'gated'`` (and is what it was with the chain), not
  under ``'fused'`` and ``'assoc'``; under autograd it runs the chain, its
  output and gradients as they were.
- The wrapper raises ``ValueError`` on what the kernel does not take.
- The plan: the run length and grid at the four scan shapes of the cells
  and of tiled eval; every (position, channel) owned by one thread; and a
  model of the kernel's threads (runs of one batch row, the K - 1 rows of
  halo before each, a window shifted a row at a time) that reproduces the
  chain bit for bit, at plans with several runs a row and channel blocks.

The kernel itself is held to the chain on the card by
``tests/test_torch_port_conv_silu_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.models import ssm
from lfsr_tpu_torch.models.ssm import Mamba
from lfsr_tpu_torch.ops import scan
from lfsr_tpu_torch.ops.scan import (
    CONV_SILU_SHAPE, conv_silu, conv_silu_fused, conv_silu_path, conv_silu_plain, conv_silu_plan,
)

from _torch_port import one_torch_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132


def _operands(B, L, Di, K, dtype, half=True, seed=0):
    """xs [B, L, Di] (``half``: xz[..., :Di] of in_proj's output [B, L,
    2 Di], else contiguous), wconv [K, Di] as the model views conv1d's
    weight [Di, 1, K] (strides (1, K)), bconv [Di]."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn(B, L, 2 * Di, generator=g).to(dtype)
    xs = xz[..., :Di] if half else xz[..., :Di].contiguous()
    wconv = (0.5 * torch.randn(Di, 1, K, generator=g))[:, 0, :].t()
    return xs, wconv, 0.5 * torch.randn(Di, generator=g)


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


@pytest.mark.parametrize("half", [True, False], ids=["xz-half", "contiguous"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Di", [20, 80])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("L", [2, 37])
def test_the_wrapper_on_the_cpu_is_the_chain(L, K, Di, dtype, half):
    xs, wconv, bconv = _operands(3, L, Di, K, dtype, half)
    trace.reset_counts("launches/K14")
    got = conv_silu_fused(xs, wconv, bconv)
    assert trace.counts("launches/K14") == {"": 0, "/vec": 0, "/elem": 0}
    want = conv_silu(xs, wconv, bconv, dtype)
    assert got.dtype == dtype and got.shape == xs.shape and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_gradient_is_autograd_through_the_chain(dtype):
    xs, wconv, bconv = _operands(2, 19, 16, 4, dtype)
    dy = torch.randn(2, 19, 16, generator=torch.Generator().manual_seed(4)).to(dtype)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in (xs, wconv, bconv)]
        return torch.autograd.grad(fn(*ins), ins, dy)

    got = grads(conv_silu_fused)
    want = grads(lambda x, w, b: conv_silu(x, w, b, dtype))
    for gk, gw in zip(got, want):
        assert gk.dtype == gw.dtype and torch.equal(gk, gw)


def _mamba(impl, dtype, seed=3):
    """A small Mamba (D 16, d_state 4, K 4, expand 1.25: Di 20) with seeded
    parameters."""
    m = Mamba(16, 4, 4, 1.25, scan_impl=impl, dtype=dtype, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
        m.A_log.copy_(torch.log(torch.arange(1, 5, dtype=F32)).repeat(20, 1))
        m.D.fill_(1.0)
    return m


@pytest.mark.parametrize("grad", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("impl,takes", [("pallas", True), ("gated", True), ("fused", False),
                                        ("assoc", False)])
def test_mamba_takes_k14_under_pallas_and_gated(impl, takes, dtype, grad, monkeypatch):
    """With no gradient wanted; under autograd the block runs the chain, and
    its output and gradients are what they were."""
    m = _mamba(impl, dtype)
    x = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(5))
    calls = []

    def recorded(xs, wconv, bconv):
        calls.append((xs.shape, xs.dtype, xs.stride(), wconv.shape, bconv.shape))
        return conv_silu_fused(xs, wconv, bconv)

    def run():
        with torch.set_grad_enabled(grad):
            y = m(x)
        if not grad:
            return (y,)
        return (y.detach(), *torch.autograd.grad(y.float().sum(), list(m.parameters())))

    monkeypatch.setattr(ssm, "conv_silu_fused", recorded)
    got = run()
    # the block's expression before K14: the chain in the compute dtype
    monkeypatch.setattr(ssm, "conv_silu_fused", lambda xs, w, b: conv_silu(xs, w, b, dtype))
    want = run()
    takes = takes and not grad
    assert calls == ([((2, 40, 20), dtype, (40 * 40, 40, 1), (4, 20), (20,))] if takes else [])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _bad_calls():
    xs, wconv, bconv = _operands(2, 9, 16, 4, F32)
    yield "xs 2-d", (xs[0], wconv, bconv)
    yield "xs float16", (xs.half(), wconv, bconv)
    yield "xs L 0", (xs[:, :0], wconv, bconv)
    yield "K 0", (xs, wconv[:0], bconv)
    yield "K 9", (xs, torch.zeros(9, 16), bconv)
    yield "wconv [K, Di + 1]", (xs, torch.zeros(4, 17), bconv)
    yield "wconv 1-d", (xs, wconv[0], bconv)
    yield "wconv bf16", (xs, wconv.to(BF16), bconv)
    yield "bconv bf16", (xs, wconv, bconv.to(BF16))
    yield "bconv [Di + 1]", (xs, wconv, torch.zeros(17))


@pytest.mark.parametrize("what,args", list(_bad_calls()), ids=[w for w, _ in _bad_calls()])
def test_refuses_what_it_does_not_take(what, args):
    with pytest.raises(ValueError, match="conv_silu"):
        conv_silu_fused(*args)


def test_the_lanes_by_what_the_kernel_can_load():
    """16-byte lanes where Di and the row stride are multiples of a lane and
    xs is 16-byte aligned: in_proj's output's half at the flagship's Di 80
    in both dtypes and the dryrun's Di 20 in float32; one channel a lane
    at Di 20 in bf16 and off the 16 bytes."""
    for dtype, Di, path in ((BF16, 80, "vec"), (F32, 80, "vec"), (F32, 20, "vec"),
                            (BF16, 20, "elem"), (BF16, 36, "elem")):
        xz = torch.zeros(2, 5, 2 * Di, dtype=dtype)
        assert conv_silu_path(xz[..., :Di], 2 * Di) == path, (dtype, Di)
    xz = torch.zeros(2, 5, 161, dtype=BF16)
    assert conv_silu_path(xz[..., :80], 161) == "elem"  # the row stride off the lane
    xz = torch.zeros(2, 5, 160, dtype=BF16)
    assert conv_silu_path(xz[..., 8:88], 160) == "vec"  # 16 bytes in
    assert conv_silu_path(xz[..., 1:81], 160) == "elem"  # 2 bytes in: not aligned


# the scans of the cells and of tiled eval: (B, L, Di) -> (run, CTAs) in bf16
# and in float32
CELLS = {
    "synth": ((4, 518400, 80), (309, 132), (655, 264)),
    "real": ((4, 563200, 80), (335, 132), (712, 264)),
    "train": ((8, 25600, 80), (31, 130), (65, 263)),
    "tiled": ((2, 25600, 80), (8, 126), (17, 251)),
}


@pytest.mark.parametrize("cell", CELLS)
def test_the_plan_at_the_cells_shapes(cell):
    """At Di 80, bf16: 10 lanes of 8 a row, 51 runs of them in a CTA of 512
    threads, one CTA an SM (its SiLU table fills shared memory); float32: 20
    lanes of 4, 12 runs in a CTA of 256, two an SM. The shortest run whose B
    ceil(L / run) runs fill one wave of those CTAs on 132 SMs at most
    (Synth and Real fill it to the last CTA)."""
    (B, L, Di), *want = CELLS[cell]
    for dtype, (run, ctas), shape in zip((BF16, F32), want, ((8, 10, 51), (4, 20, 12))):
        p = conv_silu_plan(B, L, Di, dtype, "vec", H100_SMS)
        threads, per_sm = CONV_SILU_SHAPE[dtype]
        wave = H100_SMS * per_sm
        assert (p.vw, p.lanes_cta, p.runs_cta) == shape
        assert (p.run, p.grid) == (run, (ctas, 1))
        runs = B * -(-L // p.run)
        assert p.grid[0] == -(-runs // p.runs_cta) <= wave
        assert B * -(-L // (p.run - 1)) > wave * p.runs_cta  # a shorter run would not fit
        assert p.lanes_cta * p.runs_cta <= threads


def _threads(p, B, L, Di, dtype):
    """The kernel's threads as (b, t0, rows, lane): ``conv_silu_kernel``'s
    index arithmetic over the plan's grid."""
    lanes = Di // p.vw
    runs_row = -(-L // p.run)
    out = []
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            for tid in range(CONV_SILU_SHAPE[dtype][0]):
                lane_in, run_in = tid % p.lanes_cta, tid // p.lanes_cta
                lane = by * p.lanes_cta + lane_in
                r = bx * p.runs_cta + run_in
                if run_in >= p.runs_cta or lane >= lanes or r >= B * runs_row:
                    continue
                b, j = divmod(r, runs_row)
                out.append((b, j * p.run, min(p.run, L - j * p.run), lane))
    return out


def _kernel_model(xs, wconv, bconv, p):
    """K14 as its threads compute it: each (run, lane) loads the K - 1 rows
    before its run (zeros before t = 0), then a row at a time shifts its
    window and computes the chain's roundings on it. SiLU is applied to the
    whole map at the end: the CPU's F.silu rounds a short tail of a tensor
    otherwise than its vectorised body (the card computes each element
    alike)."""
    B, L, Di = xs.shape
    dt, K = xs.dtype, wconv.shape[0]
    w, bias = wconv.to(dt), bconv.to(dt)
    pre = torch.full_like(xs, float("nan"))
    owned = torch.zeros(B, L, Di, dtype=torch.int32)
    for b, t0, rows, lane in _threads(p, B, L, Di, dt):
        c = slice(lane * p.vw, (lane + 1) * p.vw)
        win = [xs[b, t0 - back, c] if t0 >= back else torch.zeros(p.vw, dtype=dt)
               for back in range(K - 1, 0, -1)]
        for t in range(t0, t0 + rows):
            win.append(xs[b, t, c])
            acc = win[0] * w[0, c]
            for k in range(1, K):
                acc = acc + win[k] * w[k, c]
            pre[b, t, c] = bias[c] + acc
            owned[b, t, c] += 1
            win.pop(0)
    assert bool((owned == 1).all())  # every (position, channel) once
    return F.silu(pre)


@pytest.mark.parametrize("case", [
    # (B, L, Di, K, dtype, path, SMs): several runs a batch row, runs
    # shorter than the halo, a run a row, 2 channel blocks (elem, Di 300)
    (3, 50, 16, 4, BF16, "vec", 1),
    (2, 23, 12, 3, F32, "vec", 1),
    (3, 7, 20, 4, BF16, "elem", 1),
    (2, 3, 16, 4, BF16, "vec", 1),
    (2, 40, 16, 8, F32, "vec", 132),
    (2, 9, 300, 2, F32, "elem", 1),
], ids=str)
def test_a_model_of_the_kernels_threads_is_the_chain(case):
    B, L, Di, K, dtype, path, sms = case
    xs, wconv, bconv = _operands(B, L, Di, K, dtype, seed=7)
    p = conv_silu_plan(B, L, Di, dtype, path, sms)
    assert B * -(-L // p.run) > 1 and (p.grid[1] > 1) == (Di == 300)
    got = _kernel_model(xs, wconv, bconv, p)
    assert torch.equal(_bits(got), _bits(conv_silu_plain(xs, wconv, bconv)))


def test_k14_is_listed_for_the_benchmark():
    from lfsr_tpu_torch.ops import KERNELS

    fn, src, tpu = KERNELS["K14 conv_silu_fused"]
    assert fn is scan.conv_silu_fused and src.endswith("csrc/conv_silu.cu")
    assert tpu.startswith("none")

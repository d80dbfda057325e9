"""Port vs JAX: K7's float32-input mode, which is JAX's plain branch.

Below the TPU's gate (and on non-square maps) the JAX block takes the LN on
its float32 residual stream, ``nn.LayerNorm(dtype=dt)``, and runs
``MultiScaleLocal`` on the rounded xn (``lfsr_tpu/models/lfmambax.py:317-
318``). The port runs K7 there with float32 x and weights of the compute
dtype; its plain twin ``ln_msl_plain`` (what the wrapper takes on the CPU)
is held here against that JAX composition on the same numpy inputs, as is
its ``PlainVJP`` gradient against ``jax.grad`` and a whole block at a
non-square shape against the JAX block. The wrapper's launch plan
(``_cuda``'s checks and launch replaced by recorders) is read too: which
kernel and which dtype codes each mode takes.

Tolerances, by compute dtype (of the output scale max(1, max|JAX|)):
float32 1e-5 (sums in another order); bfloat16 one bf16 ulp of the scale
for the outputs (an xn rounded the other way moves taps and products by an
ulp); gradients 1e-5 (float32) and, in bfloat16, the larger of 2e-2 and
twice JAX's own bf16 noise (its bf16 gradient against its float32 one on
the same params: each depthwise tap's gradient sums B H W bf16-rounded
products, ~4.5% of scale on both sides at 2 x 16 x 24); the block 1e-4 in float32 and 2e-2 in
bfloat16 (JAX's CPU Mamba is all-float32, the port follows the TPU's bf16
split).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as nn

from lfsr_tpu.models import lfmambax as jlfm
from lfsr_tpu_torch import trace
from lfsr_tpu_torch import bridge
from lfsr_tpu_torch.models import lfmambax as tlfm
from lfsr_tpu_torch.ops import _cuda, block

RNG = np.random.default_rng(12)
SHAPES = [(2, 16, 24), (1, 16, 16)]  # non-square; square but below the gate
SHAPE_IDS = ["2x16x24", "1x16x16"]


class JaxPlainBranch(nn.Module):
    """The JAX block's plain branch: LayerNorm on x, MultiScaleLocal on xn."""

    feats: int
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x):
        xn = nn.LayerNorm(dtype=self.dtype)(x)
        return xn, jlfm.MultiScaleLocal(self.feats, self.dtype)(xn)


def _perturbed(params, s=0.2):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    leaves = [np.asarray(l, np.float32) + s * RNG.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, [jnp.asarray(l) for l in leaves])


def _branch(C, dtype):
    """(JAX module, its perturbed params, x) at C channels."""
    mod = JaxPlainBranch(C, getattr(jnp, dtype))
    params = mod.init(jax.random.key(0), jnp.zeros((1, 8, 8, C)))["params"]
    return mod, _perturbed(params)


def _port_weights(params, dtype, grad=False):
    """The port block's K7 operands from the JAX params: gamma, beta and
    the raw (wh, wm, wk) leaves, and the folded (whm, wrest, wk) in the
    compute dtype, as ``LFVSSMBlock.forward`` builds them."""
    dt = getattr(torch, dtype)
    ln, mp = params["LayerNorm_0"], params["MultiScaleLocal_0"]
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)
    leaves = {"scale": t(ln["scale"]), "bias": t(ln["bias"]), "wh": t(mp["Conv_0"]["kernel"]),
              "wm": t(mp["Conv_2"]["kernel"]), "wk": t(mp["Conv_1"]["kernel"])}
    c = leaves["wh"].shape[-1]
    wh = leaves["wh"].reshape(c, c).to(dt)
    wm = leaves["wm"].reshape(-1, leaves["wm"].shape[-1]).to(dt)
    wk = leaves["wk"][:, :, 0, :].to(dt)
    return leaves, (leaves["scale"], leaves["bias"], wh @ wm[:c], wm[c:], wk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_f32_input_twin_is_jax_plain_branch(dtype, C, shape):
    mod, params = _branch(C, dtype)
    x = RNG.standard_normal((*shape, C)).astype(np.float32) * 2 + 0.5
    assert not block.ln_msl_supported(torch.from_numpy(x))  # JAX takes its plain branch
    want = jax.jit(mod.apply)({"params": params}, jnp.asarray(x))
    _, (g, b, whm, wrest, wk) = _port_weights(params, dtype)
    got = block.ln_msl(torch.from_numpy(x), g, b, whm, wrest, wk)
    for w, t in zip(want, got):
        assert t.dtype == getattr(torch, dtype) and t.shape == w.shape
        w = np.asarray(w.astype(jnp.float32))
        scale = max(1.0, float(np.abs(w).max()))
        tol = 1e-5 * scale if dtype == "float32" else 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(t.float().numpy(), w, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_input_gradient_is_jax_grad(dtype):
    """d(sum(xn * gx) + sum(local * gl)) by the PlainVJP (kernel forward on
    the card, the twin here; the twin's gradient) against jax.grad of the
    JAX plain branch: x, gamma, beta and the raw Conv_0/Conv_1/Conv_2
    kernels (the port folds them into whm, wrest, wk under autograd)."""
    C, shape = 32, (2, 16, 24)
    mod, params = _branch(C, dtype)
    x = RNG.standard_normal((*shape, C)).astype(np.float32)
    gx, gl = (RNG.standard_normal((*shape, C)).astype(np.float32) for _ in range(2))

    def grads(m):
        def loss(p, xx):
            xn, local = m.apply({"params": p}, xx)
            return (jnp.sum(xn.astype(jnp.float32) * gx)
                    + jnp.sum(local.astype(jnp.float32) * gl))

        gp, gxx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
        ln, mp = gp["LayerNorm_0"], gp["MultiScaleLocal_0"]
        return [np.asarray(a, np.float32) for a in (
            gxx, ln["scale"], ln["bias"], mp["Conv_0"]["kernel"], mp["Conv_2"]["kernel"],
            mp["Conv_1"]["kernel"])]

    want = grads(mod)
    # JAX's own bf16 rounding noise: the same params in float32
    noise = [np.abs(a - b).max() for a, b in zip(want, grads(JaxPlainBranch(C, jnp.float32)))]
    leaves, operands = _port_weights(params, dtype, grad=True)
    xt = torch.tensor(x, requires_grad=True)
    xn, local = block.ln_msl(xt, *operands)
    tloss = ((xn.float() * torch.from_numpy(gx)).sum()
             + (local.float() * torch.from_numpy(gl)).sum())
    tg = torch.autograd.grad(tloss, [xt, *leaves.values()])
    for name, w, t, nz in zip(["x", "gamma", "beta", "Conv_0", "Conv_2", "Conv_1"], want, tg,
                              noise):
        scale = max(1.0, float(np.abs(w).max()))
        tol = 1e-5 * scale if dtype == "float32" else max(2e-2 * scale, 2 * nz)
        err = float(np.abs(t.detach().numpy().reshape(w.shape) - w).max())
        assert err <= tol, (name, err, tol)


def _block_pair(C, dtype):
    """A JAX LFVSSMBlock's perturbed params and the port block loaded from
    them."""
    jdt = getattr(jnp, dtype)
    jblock = jlfm.LFVSSMBlock(C, 4, 4, 1.25, 0.15, jdt)
    params = _perturbed(jax.jit(jblock.init)(jax.random.key(1), jnp.zeros((1, 16, 16, C)))
                        ["params"], s=0.05)
    sd = {}
    for path, leaf in bridge._flatten(params):
        key, arr = bridge._convert(path, np.asarray(leaf, np.float32))
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    with torch.device("meta"):
        tblock = tlfm.LFVSSMBlock(C, 4, 4, 1.25, getattr(torch, dtype))
    tblock = tblock.to_empty(device="cpu").eval()
    tblock.load_state_dict(sd, strict=True)
    return jblock, params, tblock


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_block_at_a_non_square_shape_matches_jax(monkeypatch, dtype, tol):
    """The port block takes K7 in the float32-input mode (its twin here) on
    a non-square map, where the JAX block runs its plain branch."""
    jblock, params, tblock = _block_pair(32, dtype)
    x = RNG.standard_normal((2, 16, 24, 32)).astype(np.float32)
    seen = []

    def spy(xx, *args):
        seen.append(xx.dtype)
        return block.ln_msl(xx, *args)

    monkeypatch.setattr(tlfm, "ln_msl", spy)
    want = np.asarray(jax.jit(jblock.apply)({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x))
    assert seen == [torch.float32] and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=tol * scale, rtol=0)


# ---- the wrapper's launch plan, without a card --------------------------------

@pytest.fixture
def launches(monkeypatch):
    """The wrapper takes its kernel path on CPU tensors and every launch is
    recorded as (entry point, args) instead of run."""
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


def _operands(x_dtype, w_dtype, C=64, shape=(1, 8, 8)):
    g = torch.Generator().manual_seed(3)
    c4 = C // 4
    rn = lambda *s: torch.randn(*s, generator=g)
    return (rn(*shape, C).to(x_dtype), rn(C), rn(C), rn(c4, C).to(w_dtype),
            rn(C - c4, C).to(w_dtype), rn(3, 3, C - c4).to(w_dtype))


@pytest.mark.parametrize("x_dtype,w_dtype,path", [
    (torch.float32, torch.bfloat16, "mma"), (torch.bfloat16, torch.bfloat16, "mma"),
    (torch.float32, torch.float32, "fma")], ids=["f32_input", "bf16", "f32"])
def test_k7_launch_by_mode(launches, x_dtype, w_dtype, path):
    """The outputs take the weights' dtype; the entry gets x's dtype code and
    the weights' (the mode); bfloat16 weights take "mma", float32 "fma"."""
    args = _operands(x_dtype, w_dtype)
    before = trace.counts("launches/K7/")
    xn, local = block.ln_msl(*args)
    ((name, a),) = launches
    assert name == "lfsr_ln_msl" and xn.dtype == local.dtype == w_dtype
    assert a[8:13] == (1, 8, 8, 64, 16)
    assert a[15:17] == (_cuda.DTYPE_CODES[x_dtype], _cuda.DTYPE_CODES[w_dtype])
    assert block.kernel_path(w_dtype) == path
    assert trace.counts("launches/K7/") == {k: v + (k == path) for k, v in before.items()}


@pytest.mark.parametrize("C,c4,takes", [(64, 16, True), (16, 4, True), (128, 32, True),
                                         (48, 12, True), (24, 6, False), (144, 36, False),
                                         (64, 0, False), (64, 64, False)])
def test_k7_envelope(C, c4, takes):
    x = torch.empty(2, 5, 7, C, device="meta")
    assert block.ln_msl_takes(x, c4) == takes
    assert not block.ln_msl_takes(torch.empty(5, 7, C, device="meta"), c4)


def test_k7_refuses_bf16_x_with_float32_weights(launches):
    with pytest.raises(ValueError, match="float32-input"):
        block.ln_msl(*_operands(torch.bfloat16, torch.float32))
    assert not launches

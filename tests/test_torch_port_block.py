"""Port vs JAX: K7 (the fused LayerNorm + MultiScaleLocal front) and the
LFVSSMBlock branch that takes it.

The JAX side runs ``pallas_block.ln_msl`` as its own tests run it on the
CPU: the Pallas kernel in interpret mode via ``FORCE_KERNEL_INTERPRET``
(set and restored by a fixture), which also drops JAX's pixel gate; the
port's gate is lowered with ``monkeypatch`` where a test needs a small
engaged block. Tolerances: float32 1e-5 (LayerNorm sums in another order);
bfloat16 one bf16 ulp of the output scale (an xn rounded the other way
moves the taps and products by an ulp); the block in bfloat16 2e-2 (JAX's
CPU Mamba is all-float32, the port follows the TPU's bf16 split).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lfsr_tpu.models import lfmambax as jlfm
from lfsr_tpu.ops import pallas_block as jpb
from lfsr_tpu_torch import bridge, trace
from lfsr_tpu_torch.models import lfmambax as tlfm
from lfsr_tpu_torch.ops import block

RNG = np.random.default_rng(7)
BLOCK_BF16_TOL = 2e-2


@pytest.fixture
def k7_interpret():
    jpb.FORCE_KERNEL_INTERPRET = True
    yield
    jpb.FORCE_KERNEL_INTERPRET = False


def _rn(*shape, s=1.0):
    return (RNG.standard_normal(shape) * s).astype(np.float32)


def _k7_inputs(B, S, C):
    c4 = C // 4
    return (_rn(B, S, S, C), 1 + _rn(C, s=0.2), _rn(C, s=0.1), _rn(c4, C, s=C**-0.5),
            _rn(C - c4, C, s=C**-0.5), _rn(3, 3, C - c4, s=0.3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 24, 64), (2, 16, 32)], ids=["1x24x24x64", "2x16x16x32"])
def test_k7_twin_matches_pallas_kernel(k7_interpret, dtype, shape):
    x, g, b, whm, wrest, wk = _k7_inputs(*shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    as_j = lambda a: jnp.asarray(a).astype(jdt)
    as_t = lambda a: torch.from_numpy(a).to(tdt)
    assert jpb._supported(as_j(x))  # the Pallas kernel, not its XLA fallback
    want = jpb.ln_msl(as_j(x), jnp.asarray(g), jnp.asarray(b), as_j(whm), as_j(wrest), as_j(wk))
    got = block.ln_msl(as_t(x), torch.from_numpy(g), torch.from_numpy(b), as_t(whm),
                       as_t(wrest), as_t(wk))
    for w, t in zip(want, got):
        assert t.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        scale = np.abs(w).max()
        tol = 1e-5 if dtype == "float32" else 2.0 ** (np.floor(np.log2(scale)) - 7)
        np.testing.assert_allclose(t.float().numpy(), w, atol=tol, rtol=0)


def test_k7_wrapper_takes_twin_on_cpu_without_counting():
    args = [torch.from_numpy(a) for a in _k7_inputs(1, 8, 16)]
    before = trace.counter("launches/K7")
    got = block.ln_msl(*args)
    assert trace.counter("launches/K7") == before
    for g, w in zip(got, block.ln_msl_plain(*args)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


GATE_TABLE = [
    # (shape, dtype, engaged)
    ((1, 160, 160, 64), "float32", False),   # below the pixel gate (tiled eval)
    ((1, 320, 320, 64), "float32", True),    # exactly at the gate
    ((1, 720, 720, 64), "float32", True),    # one Synth mosaic
    ((4, 720, 720, 64), "float32", True),    # a Synth dispatch
    ((4, 720, 720, 64), "bfloat16", True),
    ((4, 640, 880, 64), "float32", False),   # a Real dispatch: not square
    ((4, 644, 644, 64), "float32", False),   # h % 8 != 0
    ((4, 720, 720, 16), "float32", False),   # C = 16: c/4 off the tile
    ((4, 720, 720, 32), "float32", True),    # the tile follows the dtype:
    ((4, 720, 720, 32), "bfloat16", False),  # 8 for float32, 16 for bf16
    ((4, 720, 720), "float32", False),       # not 4-D
]


@pytest.mark.parametrize("shape,dtype,engaged", GATE_TABLE,
                         ids=[f"{'x'.join(map(str, s))}-{d}" for s, d, _ in GATE_TABLE])
def test_gate_equals_tpu_gate(monkeypatch, shape, dtype, engaged):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jpb._supported(jax.ShapeDtypeStruct(shape, getattr(jnp, dtype)))
    got = block.ln_msl_supported(torch.empty(shape, dtype=getattr(torch, dtype), device="meta"))
    assert got == want == engaged


def _block_pair(C=32, N=4):
    """A JAX LFVSSMBlock's perturbed params and the port block loaded from
    them (bfloat16 compute, as the flagship)."""
    x0 = jnp.zeros((1, 16, 16, C))
    jblock = jlfm.LFVSSMBlock(C, N, 4, 1.25, 0.15, jnp.bfloat16)
    params = jax.jit(jblock.init)(jax.random.key(0), x0)["params"]
    leaves, tdef = jax.tree_util.tree_flatten(params)
    leaves = [np.asarray(l) + 0.05 * RNG.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    params = jax.tree_util.tree_unflatten(tdef, leaves)
    sd = {}
    for path, leaf in bridge._flatten(params):
        key, arr = bridge._convert(path, np.asarray(leaf, np.float32))
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    with torch.device("meta"):
        tblock = tlfm.LFVSSMBlock(C, N, 4, 1.25, torch.bfloat16)
    tblock = tblock.to_empty(device="cpu").eval()
    tblock.load_state_dict(sd, strict=True)  # the K7 branch reads the same params
    return jblock, params, tblock


@pytest.fixture(scope="module")
def block_pair():
    return _block_pair()


def test_engaged_block_matches_jax_k7_block(k7_interpret, monkeypatch, block_pair):
    jblock, params, tblock = block_pair
    monkeypatch.setattr(block, "LN_MSL_MIN_PIXELS", 0)
    x = _rn(2, 16, 16, 32)
    assert block.ln_msl_supported(torch.from_numpy(x))
    want = np.asarray(jax.jit(jblock.apply)({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BLOCK_BF16_TOL, rtol=0)


@pytest.fixture(scope="module")
def block_pair_24():
    return _block_pair(C=24)


@pytest.mark.parametrize("shape,called", [
    ((2, 16, 16, 32), [torch.bfloat16]), ((1, 16, 16, 32), [torch.float32]),
    ((2, 16, 24, 32), [torch.float32]), ((2, 16, 16, 24), [])],
    ids=["engaged", "below_gate", "non_square", "c24"])
def test_block_calls_k7_only_at_the_gate(monkeypatch, request, shape, called):
    """K7 takes every block whose C it takes (a multiple of 16 up to 128):
    with x rounded to bf16 at the TPU's gate (JAX's K7 branch), in float32
    below it and on a non-square map (the float32-input mode: JAX's plain
    branch); at C 24 the block runs the plain modules."""
    _, _, tblock = request.getfixturevalue("block_pair_24" if shape[-1] == 24 else "block_pair")
    monkeypatch.setattr(block, "LN_MSL_MIN_PIXELS", 2 * 16 * 16)
    seen = []

    def spy(x, *args):
        seen.append(x.dtype)
        return block.ln_msl(x, *args)

    monkeypatch.setattr(tlfm, "ln_msl", spy)
    with torch.inference_mode():
        y = tblock(torch.from_numpy(_rn(*shape)))
    assert y.shape == shape and torch.isfinite(y).all()
    assert seen == called

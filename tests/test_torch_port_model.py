"""Port vs JAX: the param bridge, each flagship module, the whole model.

One flax param tree (the JAX init, perturbed so zero-initialised biases
are exercised) is converted by ``bridge.state_dict_from_flax`` and loaded
into the port; each submodule and the whole model then see the same numpy
inputs on both sides. In the float32 cases the JAX cross-scan runs through
its K4/K5 Pallas kernels in interpret mode (fixture), as on the TPU path;
K1 and K6 run the way JAX runs them on the CPU. Small config: channels 16, d_state 4,
phases ((2, 0.25), (1, None)) on 40x40 SAI patches.

Tolerances: float32 <= 2e-5 absolute (outputs are O(1); measured ~2e-7 —
float32 sums in another order); bfloat16 <= 2e-2 absolute (the two
frameworks round bf16 at a few different places, and JAX's CPU Mamba is the
all-float32 ``mamba_inner_ref`` while the port follows the TPU's bf16
split).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lfsr_tpu.config import Config
from lfsr_tpu.models import lfmambax as jlfm
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.models.ssm import Mamba as JMamba
from lfsr_tpu.ops import pallas_layout as jpl
from lfsr_tpu_torch.bridge import init_params, param_count, state_dict_from_flax
from lfsr_tpu_torch.models.registry import get_model

from _torch_port import one_torch_thread  # noqa: F401

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
F32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture
def layout_interpret():
    jpl.FORCE_KERNEL_INTERPRET = True
    yield
    jpl.FORCE_KERNEL_INTERPRET = False


def _perturbed_params(cfg, x):
    prev, jpl.FORCE_KERNEL_INTERPRET = jpl.FORCE_KERNEL_INTERPRET, False
    params = jax.jit(jget_model(cfg).init)(jax.random.key(0), jnp.asarray(x))
    jpl.FORCE_KERNEL_INTERPRET = prev
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)


def _port(cfg, params):
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return model


@pytest.fixture(scope="module")
def f32_pair():
    cfg = Config(compute_dtype="float32", model_kwargs=SMALL)
    x = np.random.default_rng(0).random((2, 40, 40, 1)).astype(np.float32)
    params = _perturbed_params(cfg, x)
    return cfg, x, params, _port(cfg, params)


def test_bridge_reproduces_default_param_count_with_no_unused_leaf():
    cfg = Config()
    shapes = jax.eval_shape(
        lambda: jget_model(cfg).init(jax.random.key(0), jnp.zeros((1, 160, 160, 1))))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(tree, cfg)
    assert param_count(sd) == 693_998
    get_model(cfg, device="meta").load_state_dict(sd, strict=True, assign=True)


def test_bridge_rejects_unused_and_missing_leaves(f32_pair):
    cfg, _, params, _ = f32_pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    extra = {"params": {**tree["params"], "stray": {"kernel": np.zeros((1, 1, 2, 2))}}}
    with pytest.raises(ValueError, match="not used"):
        state_dict_from_flax(extra, cfg)
    short = {"params": {k: v for k, v in tree["params"].items() if k != "LSFL_0"}}
    with pytest.raises(ValueError, match="not filled"):
        state_dict_from_flax(short, cfg)


def test_init_params_is_seeded_and_complete():
    cfg = Config()
    a = init_params(cfg, torch.Generator().manual_seed(0))
    b = init_params(cfg, torch.Generator().manual_seed(0))
    assert param_count(a) == 693_998
    assert all(torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all() for k in a)
    assert a["block_0.CrossScanSSM_0.mamba.A_log"][0, 3] == pytest.approx(np.log(4.0))


def _module_cases(cfg):
    c, a, dt = 16, cfg.angRes, jnp.float32
    rng = np.random.default_rng(5)
    feat = lambda: rng.standard_normal((2, 40, 40, c)).astype(np.float32)
    block = lambda p: (jlfm.LFVSSMBlock(c, 4, 4, 1.25, 0.15, dt), p["block_0"], [feat()])
    return {
        "IFE_0": lambda p: (jlfm.IFE(c, dt), p["IFE_0"],
                            [rng.random((2, 40, 40, 1)).astype(np.float32)]),
        "block_0": block,
        "block_0.CrossScanSSM_0": lambda p: (
            jlfm.CrossScanSSM(c, 4, 4, 1.25, dt), p["block_0"]["CrossScanSSM_0"], [feat()]),
        "block_0.CrossScanSSM_0.mamba": lambda p: (
            JMamba(d_model=c, d_state=4, d_conv=4, expand=1.25, dtype=dt),
            p["block_0"]["CrossScanSSM_0"]["mamba"],
            [rng.standard_normal((2, 400, c)).astype(np.float32)]),
        "block_0.ECA_0": lambda p: (jlfm.ECA(dtype=dt), p["block_0"]["ECA_0"], [feat()]),
        "win_attn_0": lambda p: (jlfm.WindowAttention(c, dtype=dt), p["win_attn_0"], [feat()]),
        "SpatialAttention_0": lambda p: (jlfm.SpatialAttention(c, dt),
                                         p["SpatialAttention_0"], [feat()]),
        "LSFL_0": lambda p: (jlfm.LSFL(c, a, dt), p["LSFL_0"], [feat()]),
        "HLFR_0": lambda p: (jlfm.HLFR(c, 4, dt), p["HLFR_0"], [feat()]),
        "ProgressiveFusion_0": lambda p: (jlfm.ProgressiveFusion(c, dt),
                                          p["ProgressiveFusion_0"],
                                          [[feat(), feat(), feat()]]),
    }


@pytest.mark.parametrize("name", list(_module_cases(Config())))
def test_module_matches_jax_f32(f32_pair, layout_interpret, name):
    cfg, _, params, model = f32_pair
    jmod, p, args = _module_cases(cfg)[name](params["params"])
    want = jax.jit(jmod.apply)({"params": p}, *[jax.tree_util.tree_map(jnp.asarray, a)
                                                 for a in args])
    tmod = model.get_submodule(name)
    targs = [[torch.from_numpy(b) for b in a] if isinstance(a, list) else torch.from_numpy(a)
             for a in args]
    with torch.inference_mode():
        got = tmod(*targs)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=F32_TOL, rtol=F32_TOL)


def test_whole_model_matches_jax_f32(f32_pair, layout_interpret):
    cfg, x, params, model = f32_pair
    want = np.asarray(jax.jit(jget_model(cfg).apply)(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 160, 160, 1)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_whole_model_matches_jax_bf16(f32_pair):
    _, x, params, _ = f32_pair  # the param tree does not depend on the compute dtype
    cfg = Config(compute_dtype="bfloat16", model_kwargs=SMALL)
    model = _port(cfg, params)
    want = np.asarray(jax.jit(jget_model(cfg).apply)(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)

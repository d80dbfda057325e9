"""Port vs JAX: EPIT's forward, its parameter tree and its tiled eval.

One flax param tree (the JAX init, perturbed so the unit/zero LayerNorm
params are exercised) is converted by ``bridge.state_dict_from_flax`` and
loaded into the port; both sides see the same numpy inputs.

- Full width (channels 64, so the transformer's d = 128 and 8 heads) with
  ``n_blocks=1`` on [1, 40, 40, 1]: L = 5 * 8 = 40 tokens, so the JAX side
  takes its Pallas kernel K8 (interpret mode on the CPU) and the port its
  K8 wrapper (the plain twin on CPU tensors). float32 SR within 1e-4
  (float32 sums in another order through 2 x 3 convs and 10 projections).
- Narrow (channels 16, d = 32): both sides take the plain attention
  (flax ``dot_product_attention`` / its PyTorch form), 1e-4.
- bfloat16 at full width, from the JAX init as it is: 2e-2 of the output
  scale max(1, max|SR|). The two frameworks round a bf16 conv or product
  at other places, so the bf16 head's output differs by about one bf16
  ulp (1/128 of its magnitude; measured 0.0195 at max|SR| 3.98).
- ``init_params`` at the registered width (5 blocks) gives the JAX init's
  parameter count and tree.
- Tiled ``evaluate_sets`` of one small scene (patch 8 / stride 4) from the
  JAX init as it is: PSNR within 1e-3 dB, SR views 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.config import Config
from lfsr_tpu.data.datasets import TestScene as JScene
from lfsr_tpu.models import epit as jepit
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.ops import pallas_masked_attention as jma
from lfsr_tpu.train import evaluate as jeval
from lfsr_tpu_torch.bridge import init_params, param_count, state_dict_from_flax
from lfsr_tpu_torch.data.datasets import TestScene
from lfsr_tpu_torch.models import epit
from lfsr_tpu_torch.models.registry import get_model, whole_scene_default
from lfsr_tpu_torch.ops import masked_attention
from lfsr_tpu_torch.train import evaluate as teval

ONE_BLOCK = {"n_blocks": 1}


def _cfg(dtype="float32", **kw):
    return Config(model_name="EPIT", compute_dtype=dtype, **kw)


def _perturbed_params(cfg, x):
    params = jax.jit(jget_model(cfg).init)(jax.random.key(0), jnp.asarray(x))
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)


def _both(cfg, x, perturb=True):
    params = (_perturbed_params(cfg, x) if perturb
              else jax.jit(jget_model(cfg).init)(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jax.jit(jget_model(cfg).apply)(params, jnp.asarray(x)))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).float().numpy()
    return got, want


def _x(shape=(1, 40, 40, 1), seed=5):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_full_width_forward_matches_jax_through_k8():
    cfg = _cfg(model_kwargs=ONE_BLOCK)
    assert masked_attention.supported(40, 128, 8) and jma.supported(40, 128, 8)
    calls = []
    wrapped = masked_attention.masked_mha_fused

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return wrapped(*args)

    epit.masked_mha_fused = spy
    try:
        got, want = _both(cfg, _x())
    finally:
        epit.masked_mha_fused = wrapped
    assert calls == [(40, 40, 128)] * 2  # both passes of the one AltFilter
    assert got.shape == want.shape == (1, 160, 160, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_narrow_forward_takes_the_plain_attention():
    cfg = _cfg(model_kwargs={"n_blocks": 1, "channels": 16})
    assert not masked_attention.supported(40, 32, 8)
    got, want = _both(cfg, _x(seed=6))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bf16_forward_matches_jax():
    got, want = _both(_cfg("bfloat16", model_kwargs=ONE_BLOCK), _x(seed=7), perturb=False)
    np.testing.assert_allclose(got, want, atol=2e-2 * max(1.0, np.abs(want).max()), rtol=0)


def test_init_params_matches_the_jax_tree():
    cfg = Config(model_name="EPIT")  # the registered width: 64 channels, 5 blocks
    shapes = jax.eval_shape(jget_model(cfg).init, jax.random.key(0),
                            jnp.zeros((1, 160, 160, 1)))
    leaves = jax.tree_util.tree_leaves(shapes)
    n_jax = sum(int(np.prod(l.shape)) for l in leaves)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    assert param_count(sd) == n_jax == 1_470_080
    # every flax leaf maps onto a port parameter of the same shape, and back
    zeros = jax.tree_util.tree_map(lambda l: np.zeros(l.shape, np.float32), shapes)
    mapped = state_dict_from_flax(zeros, cfg)
    assert {k: tuple(v.shape) for k, v in mapped.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    ln = [k for k in sd if ".LayerNorm_" in k]
    assert len(ln) == 5 * 2 * 2
    for k in ln:
        assert torch.all(sd[k] == (1.0 if k.endswith("weight") else 0.0)), k
    w = sd["_AltFilter_0._EPITransformer_0.Dense_5.weight"]  # lecun normal, fan_in 128
    assert w.shape == (256, 128) and abs(w.std().item() - 128**-0.5) < 0.01


def test_band_mask_matches_jax():
    for geom in ((5, 8, 10, 11), (5, 32, 10, 11), (3, 7, 6, 5)):
        np.testing.assert_array_equal(epit._band_mask(*geom), jepit._band_mask(*geom))
    m = epit.band_mask(5, 32, 10, 11, torch.device("cpu"))
    assert m.shape == (160, 160) and m.dtype == torch.float32
    assert torch.all(m.diagonal() == 0)  # every row keeps its own token


def _scene(ang=5, h0=16, s=4):
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0 : h0 * s, 0 : h0 * s] / (h0 * s)
    views = np.empty((ang, ang, h0 * s, h0 * s), np.float32)
    for u in range(ang):
        for v in range(ang):
            views[u, v] = 0.5 + 0.4 * np.sin(6 * (yy + 0.01 * u) + 4 * (xx + 0.01 * v))
    views += 0.01 * rng.standard_normal(views.shape).astype(np.float32)
    lr = views.reshape(ang, ang, h0, s, h0, s).mean(axis=(3, 5))
    sai = lambda a: a.transpose(0, 2, 1, 3).reshape(ang * a.shape[2], ang * a.shape[3])
    return dict(name="toy", dataset="Synthetic", lr_y=sai(lr).astype(np.float32),
                hr_y=sai(views), sr_cbcr=np.zeros((ang * h0 * s, ang * h0 * s, 2), np.float32))


def test_tiled_evaluate_sets_matches_jax():
    cfg = _cfg(model_kwargs=ONE_BLOCK, patch_size_for_test=8, stride_for_test=4)
    assert not whole_scene_default(cfg)  # EPIT evaluates tiled by default
    fields = _scene()
    jmodel = jget_model(cfg)  # its init as it is: SR of the scene's own scale
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 40, 40, 1)))
    want = jeval.evaluate_sets(jmodel.apply, params, {"Synthetic": [JScene(**fields)]}, cfg,
                               log=lambda m: None)
    _, _, want_views = jeval.evaluate_scene(jmodel.apply, params, JScene(**fields), cfg)

    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    got = teval.evaluate_sets(model, {"Synthetic": [TestScene(**fields)]}, cfg,
                              log=lambda m: None, keep_views=True)
    views = got["Synthetic"]["views"]["toy"]
    assert tuple(views.shape) == (5, 5, 64, 64)
    np.testing.assert_allclose(views.numpy(), np.asarray(want_views), atol=1e-4, rtol=0)
    assert abs(got["Synthetic"]["psnr"] - want["Synthetic"]["psnr"]) < 1e-3
    assert abs(got["Synthetic"]["ssim"] - want["Synthetic"]["ssim"]) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_keeps_the_compute_dtype(dtype):
    cfg = _cfg(dtype, model_kwargs={"n_blocks": 1, "channels": 16})
    model = get_model(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    seen = []
    hook = model._AltFilter_0._EPITransformer_0.register_forward_hook(
        lambda mod, inp, out: seen.append(out.dtype))
    with torch.inference_mode():
        y = model(torch.from_numpy(_x((2, 40, 40, 1))))
    hook.remove()
    assert y.dtype == torch.float32 and y.shape == (2, 160, 160, 1)
    assert seen == [getattr(torch, dtype)] * 2

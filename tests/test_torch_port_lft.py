"""Port vs JAX and vs the plain reference: LFT's forward, its parameter
tree, its tiled eval and one train step, on the CPU.

One flax param tree (the JAX init at 64 channels with one block, perturbed
so the unit/zero LayerNorm params are exercised) is converted by
``bridge.state_dict_from_flax`` and loaded into the port; both sides see
the same numpy input [1, 40, 40, 1] (5 x 5 views of 8 x 8: the angular
attention's 25 tokens take K8 with a zero mask, the spatial one's 64 take
K12, each wrapper's plain twin on CPU tensors; JAX takes flax's dense
attention and its ``local_window_mha``).

- float32 SR within 1e-4 of JAX (float32 sums in another order through 4
  convs, 14 projections and the two attentions).
- bfloat16 from the JAX init as it is: 2e-2 of the output scale max(1,
  max|SR|). The frameworks round a bf16 conv or product at other places,
  and JAX's angular attention runs its scores and softmax in bf16 where K8
  keeps float32, so the bf16 head's output differs by about one bf16 ulp
  (1/128 of its magnitude).
- Against ``portbench/reference/lft.py`` (plain float32, the banded
  attention as a gathered dense softmax) on the benchmark's seeded weights:
  within 1e-5 of the scale; the reference rounded as a bf16 model in the
  port's place misses that by three orders of magnitude.
- Tiled ``evaluate_sets`` of one small scene (patch 8 / stride 4, 8
  tiles a call): PSNR within 1e-3 dB and SSIM within 1e-4 of JAX.
- One ``Trainer`` step (float32, L1, masking and augmentation on): the loss
  within 1e-5 relative and the clipped gradient's leaf norms within 1e-4 of
  the reference's autograd on the same rows and draws.
- ``init_params`` at the registered width (64 channels, 4 blocks) gives
  the JAX init's tree and its 1,163,392 parameters; the efficiency gate
  still refuses LFT (it counts MACs of LFMambaX alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.config import Config
from lfsr_tpu.data.datasets import TestScene as JScene
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.train import evaluate as jeval
from lfsr_tpu_torch.bridge import init_params, param_count, state_dict_from_flax
from lfsr_tpu_torch.data.datasets import TestScene, TrainArrays
from lfsr_tpu_torch.models import lft
from lfsr_tpu_torch.models.registry import get_model, spec, whole_scene_default
from lfsr_tpu_torch.tools.efficiency import check_efficiency
from lfsr_tpu_torch.train import evaluate as teval
from lfsr_tpu_torch.train.trainer import Trainer
from portbench.harness import checks, data, seeds
from portbench.harness.weights import make_weights
from portbench.reference import lft as ref
from portbench.reference import train as ref_train
from portbench.reference.common import Prec

from _torch_port import one_torch_thread  # noqa: F401

ONE_BLOCK = {"n_blocks": 1}
X = np.random.default_rng(5).random((1, 40, 40, 1)).astype(np.float32)


def _cfg(dtype="float32", **kw):
    return Config(model_name="LFT", compute_dtype=dtype, model_kwargs=ONE_BLOCK, **kw)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init at one block (its tree does not depend on the dtype)."""
    return jax.jit(jget_model(_cfg()).init)(jax.random.key(0), jnp.asarray(X))


def _perturbed(params):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)


def _port(cfg, state):
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


@pytest.mark.parametrize("dtype,perturb,tol", [("float32", True, 1e-4), ("bfloat16", False, 2e-2)])
def test_forward_matches_jax(jax_init, dtype, perturb, tol):
    cfg = _cfg(dtype)
    params = _perturbed(jax_init) if perturb else jax_init
    want = np.asarray(jax.jit(jget_model(cfg).apply)(params, jnp.asarray(X)))
    model = _port(cfg, state_dict_from_flax(params, cfg))
    calls = []
    wrapped = lft.local_window_mha

    def spy(*args):
        calls.append(args[3:])
        return wrapped(*args)

    lft.local_window_mha = spy
    try:
        with torch.inference_mode():
            got = model(torch.from_numpy(X)).numpy()
    finally:
        lft.local_window_mha = wrapped
    assert calls == [(8, 8, 8, 5, 5)]  # the one SpaTrans: 8 heads over 8 x 8 tokens, 5 x 5
    assert got.shape == want.shape == (1, 160, 160, 1)
    scale = 1.0 if perturb else max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def test_forward_matches_the_reference_and_its_bf16_control_does_not():
    weights = make_weights(ref.param_specs(ONE_BLOCK), 2**31 + 18, "cpu")
    model = _port(_cfg(), weights)
    x = torch.from_numpy(X)
    with torch.inference_mode():
        got = model(x)
        want = ref.forward(weights, x, ONE_BLOCK)
        control = ref.forward(weights, x, ONE_BLOCK, q=Prec("bfloat16"))
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (control - want).abs().max().item() > 100 * tol


def test_init_params_matches_the_jax_tree():
    cfg = Config(model_name="LFT")  # the registered width: 64 channels, 4 blocks
    assert spec("LFT").build_loss(cfg).__name__ == "l1" and not whole_scene_default(cfg)
    shapes = jax.eval_shape(jget_model(cfg).init, jax.random.key(0), jnp.zeros((1, 40, 40, 1)))
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes))
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    assert param_count(sd) == n_jax == 1_163_392
    zeros = jax.tree_util.tree_map(lambda l: np.zeros(l.shape, np.float32), shapes)
    mapped = state_dict_from_flax(zeros, cfg)
    assert {k: tuple(v.shape) for k, v in mapped.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    specs = ref.param_specs({})
    assert {k: s for k, (s, _) in specs.items()} == {k: tuple(v.shape) for k, v in sd.items()}
    with pytest.raises(NotImplementedError):  # the efficiency gate counts LFMambaX alone
        check_efficiency(cfg, device="cpu")
    ln = [k for k in sd if ".LayerNorm_" in k]
    assert len(ln) == 4 * 2 * 2 * 2
    for k in ln:
        assert torch.all(sd[k] == (1.0 if k.endswith("weight") else 0.0)), k


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


def test_tiled_evaluate_sets_matches_jax(jax_init):
    cfg = _cfg(patch_size_for_test=8, stride_for_test=4, minibatch_for_test=8)
    fields = _scene()
    jmodel = jget_model(cfg)  # its init as it is: SR of the scene's own scale
    want = jeval.evaluate_sets(jmodel.apply, jax_init, {"Synthetic": [JScene(**fields)]}, cfg,
                               log=lambda m: None)
    model = _port(cfg, state_dict_from_flax(jax_init, cfg))
    got = teval.evaluate_sets(model, {"Synthetic": [TestScene(**fields)]}, cfg,
                              log=lambda m: None, keep_views=True)
    views = got["Synthetic"]["views"]["toy"]
    assert tuple(views.shape) == (5, 5, 64, 64)
    assert abs(got["Synthetic"]["psnr"] - want["Synthetic"]["psnr"]) < 1e-3
    assert abs(got["Synthetic"]["ssim"] - want["Synthetic"]["ssim"]) < 1e-4


def test_a_train_step_follows_the_reference():
    cfg = _cfg(batch_size=2, seed=123)
    assert cfg.use_masked_pretrain and cfg.augment
    weights = make_weights(ref.param_specs(ONE_BLOCK), 2**31 + 19, "cpu")
    lr, hr = data.light_fields(seeds.rng(7, "train_pairs"), 4, (32, 32))
    tr = Trainer(cfg, 1, weights, device="cpu")
    follow = checks.Follow(tr, weights, 1)
    with follow:
        tr.run_epoch(TrainArrays(lr=lr, hr=hr), 0)
    got = follow.readings()
    want = ref_train.follow(ref, weights, lr, hr, kw=ONE_BLOCK, seed=cfg.seed, steps=1, spe=1,
                            batch=2, loss="l1", hyper=ref_train.Hyper.of(cfg), dropout=False,
                            device="cpu", rows_at_once=2)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert set(got["g1"]) == set(want["g1"]) == set(weights)
    for k in want["g1"]:
        assert abs(got["g1"][k] - want["g1"][k]) <= 1e-4 * max(want["g1"][k], 1e-3), k

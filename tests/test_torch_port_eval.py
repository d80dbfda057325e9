"""Port vs JAX: tiled ``evaluate_sets`` end to end on a tiny synthetic scene,
and which evaluation path a ``Config`` selects (whole-scene cases against
JAX are in test_torch_port_whole.py).

Small flagship config (channels 16, d_state 4, 3 blocks), float32, LR patch
8 / stride 4 (40x40 SAI patches), 16 patches in 8 minibatches of 2. SR views
must agree to 1e-4 and PSNR to 1e-3 dB (float32 sums in another order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lfsr_tpu.config import Config
from lfsr_tpu.data.datasets import TestScene as JScene
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.train import evaluate as jeval
from lfsr_tpu_torch.bridge import state_dict_from_flax
from lfsr_tpu_torch.data.datasets import TestScene
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.train import evaluate as teval

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}


def _cfg(**kw):
    return Config(compute_dtype="float32", model_kwargs=SMALL, patch_size_for_test=8,
                  stride_for_test=4, whole_scene_for_test=False, **kw)


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
    cfg = _cfg()
    fields = _scene()
    jmodel = jget_model(cfg)
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


def _nearest_model(calls):
    def fake_model(x):
        calls.append(tuple(x.shape))
        return torch.nn.functional.interpolate(
            x.permute(0, 3, 1, 2), scale_factor=4, mode="nearest").permute(0, 2, 3, 1)

    fake_model.parameters = lambda: iter([torch.zeros(1)])
    return fake_model


def test_default_config_takes_the_whole_scene_path():
    # Config() defers to the registry: LFMambaX evaluates whole scenes, 4 per
    # model call, each 16x16 view padded by 8 to a 32x32 view (160x160 mosaic)
    cfg = Config(model_kwargs=SMALL)
    calls = []
    model = _nearest_model(calls)
    scenes = [TestScene(**{**_scene(), "name": f"toy{i}"}) for i in range(5)]
    res = teval.evaluate_sets(model, {"Synthetic": scenes}, cfg, log=lambda m: None,
                              keep_views=True)
    assert calls == [(4, 160, 160, 1), (4, 160, 160, 1)]
    lr = torch.from_numpy(_scene()["lr_y"])
    want = torch.nn.functional.interpolate(lr.reshape(1, 1, 80, 80), scale_factor=4,
                                           mode="nearest")[0, 0]
    from lfsr_tpu_torch.ops.layout import views_to_sai

    for sc in scenes:
        np.testing.assert_array_equal(views_to_sai(res["Synthetic"]["views"][sc.name]).numpy(),
                                      want.numpy())
    calls.clear()
    _, _, views = teval.evaluate_scene(model, scenes[0], cfg)
    assert calls == [(1, 160, 160, 1)]
    np.testing.assert_array_equal(views_to_sai(views).numpy(), want.numpy())


def test_re_task_and_epsw_stitching_still_raise():
    model = _nearest_model([])
    scene = TestScene(**_scene())
    for cfg in (Config(model_kwargs=SMALL, task="RE"), _cfg(epsw_for_test=True)):
        with pytest.raises(NotImplementedError):
            teval.evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=lambda m: None)
        with pytest.raises(NotImplementedError):
            teval.evaluate_scene(model, scene, cfg)


def test_minibatch_padding_keeps_every_patch():
    # 16 patches in minibatches of 3: the grid is zero-padded to 18 and cut back
    calls = []
    lr = torch.from_numpy(_scene()["lr_y"])
    views = teval.sr_scene(_nearest_model(calls), lr, ang=5, scale=4, patch=8, stride=4,
                           minibatch=3, h0=16, w0=16)
    assert [c[0] for c in calls] == [3] * 6
    want = torch.nn.functional.interpolate(
        lr.reshape(1, 1, 80, 80), scale_factor=4, mode="nearest")[0, 0]
    from lfsr_tpu_torch.ops.layout import views_to_sai

    np.testing.assert_array_equal(views_to_sai(views).numpy(), want.numpy())

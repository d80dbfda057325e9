"""Port vs JAX: whole-scene evaluation.

Whole-scene ``evaluate_sets``/``evaluate_scene`` of the small float32
flagship (channels 16, d_state 4, 3 blocks) under the default ``Config``
whole mode (pad 8, rounded up to a multiple of 8), on 3 square scenes
(h0 = 16, ``whole_scene_minibatch`` 2, so the scene count is padded) and 2
non-square scenes (h0 = 12, w0 = 20, pad clamped to 4). SR views within
1e-4, PSNR within 1e-3 dB, SSIM within 1e-4 (float32 sums in another
order). The pad helper must match exactly.
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

from _torch_port import one_torch_thread  # noqa: F401

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
ANG, S = 5, 4


def scene_fields(seed, h0, w0, name=None):
    """TestScene fields of a smooth seeded 5x5 scene (LR a 4x box
    downsample of HR; chroma in [0.25, 0.75])."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : h0 * S, 0 : w0 * S] / (h0 * S)
    views = np.empty((ANG, ANG, h0 * S, w0 * S), np.float32)
    for u in range(ANG):
        for v in range(ANG):
            views[u, v] = 0.5 + 0.4 * np.sin(6 * (yy + 0.01 * u) + 4 * (xx + 0.01 * v) + seed)
    views += 0.01 * rng.standard_normal(views.shape).astype(np.float32)
    lr = views.reshape(ANG, ANG, h0, S, w0, S).mean(axis=(3, 5))
    sai = lambda a: a.transpose(0, 2, 1, 3).reshape(ANG * a.shape[2], ANG * a.shape[3])
    cbcr = 0.25 + 0.5 * rng.random((ANG * h0 * S, ANG * w0 * S, 2), dtype=np.float32)
    return dict(name=name or f"scene{seed}", dataset="Synthetic",
                lr_y=sai(lr).astype(np.float32), hr_y=sai(views), sr_cbcr=cbcr)


SETS = {"square": [scene_fields(i, 16, 16) for i in range(3)],
        "non_square": [scene_fields(10 + i, 12, 20) for i in range(2)]}


@pytest.fixture(scope="module")
def whole_pair():
    cfg = Config(compute_dtype="float32", model_kwargs=SMALL, whole_scene_minibatch=2)
    jmodel = jget_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 40, 40, 1)))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    want = jeval.evaluate_sets(jmodel.apply, params,
                               {k: [JScene(**f) for f in v] for k, v in SETS.items()}, cfg,
                               log=lambda m: None)
    got = teval.evaluate_sets(model, {k: [TestScene(**f) for f in v] for k, v in SETS.items()},
                              cfg, log=lambda m: None, keep_views=True)
    return cfg, jmodel, params, model, want, got


@pytest.mark.parametrize("name", list(SETS))
def test_whole_evaluate_sets_matches_jax(whole_pair, name):
    cfg, jmodel, params, _, want, got = whole_pair
    assert abs(got[name]["psnr"] - want[name]["psnr"]) < 1e-3
    assert abs(got[name]["ssim"] - want[name]["ssim"]) < 1e-4
    for (n, p, s), (wn, wp, ws) in zip(got[name]["scenes"], want[name]["scenes"]):
        assert n == wn and abs(p - wp) < 1e-3 and abs(s - ws) < 1e-4
    # the views of the scene-batched path against JAX's own batched runner
    f = SETS[name]
    batch = jnp.stack([jnp.asarray(x["lr_y"]) for x in f])
    want_views = jeval.sr_scenes_whole(jmodel.apply, params, batch, ang=ANG, ang_out=ANG,
                                       scale=S, whole_pad=cfg.whole_scene_pad,
                                       minibatch=cfg.whole_scene_minibatch)
    for x, wv in zip(f, want_views):
        np.testing.assert_allclose(got[name]["views"][x["name"]].numpy(), np.asarray(wv),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(SETS))
def test_whole_evaluate_scene_matches_jax(whole_pair, name):
    cfg, jmodel, params, model, _, _ = whole_pair
    f = SETS[name][0]
    wp, ws, wv = jeval.evaluate_scene(jmodel.apply, params, JScene(**f), cfg)
    p, s, v = teval.evaluate_scene(model, TestScene(**f), cfg)
    h0, w0 = f["lr_y"].shape[0] // ANG, f["lr_y"].shape[1] // ANG
    assert tuple(v.shape) == (ANG, ANG, h0 * S, w0 * S)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=1e-4, rtol=0)
    assert abs(p - wp) < 1e-3 and abs(s - ws) < 1e-4


@pytest.mark.parametrize("h0,w0,pad", [(16, 16, 8), (12, 20, 8), (10, 14, 8), (8, 20, 8),
                                       (16, 16, 0), (13, 21, 3)],
                         ids=["square", "non_square", "clamped", "p0_clamp", "pad0", "odd"])
def test_whole_pad_batch_equals_jax(h0, w0, pad):
    x = np.random.default_rng(h0 * w0).random((2, ANG * h0, ANG * w0), dtype=np.float32)
    got, p = teval._whole_pad_batch(torch.from_numpy(x), ANG, pad)
    want, wp = jeval._whole_pad_batch(jnp.asarray(x), ANG, pad)
    assert p == wp
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

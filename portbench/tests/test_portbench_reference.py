"""The benchmark's yardstick against the program, on the CPU at small sizes:
the plain reference agrees with the port's CPU path (the LFMambaX
forward, the first train steps), the evaluation geometry is the port's, and the kernel counts reproduce
``chip_smoke.work`` at the cells' shapes.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.counts import kernels as counts
from portbench.harness import checks, data, seeds, spec
from portbench.harness.weights import make_weights, param_count
from portbench.reference import common, lfmambax as ref_lfm
from portbench.tests.test_portbench_harness import SMALL

ROOT = Path(__file__).resolve().parents[2]
SEED = 31337


def _port_model(name: str, kw: dict, weights: dict):
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import get_model

    cfg = Config(model_name=name, compute_dtype="float32", model_kwargs=kw)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


@pytest.mark.parametrize("name,ref,kw,side", [
    ("LFMambaX", ref_lfm, SMALL, 40),
    ("LFMambaX", ref_lfm, {**SMALL, "channels": 32}, 80),
])
def test_reference_forward_agrees_with_the_port(name, ref, kw, side):
    weights = make_weights(ref.param_specs(kw), SEED, "cpu")
    model = _port_model(name, kw, weights)
    lr, _ = data.light_fields(seeds.rng(SEED, "lf_pool"), 2, (side // 5 * 4,) * 2)
    x = torch.as_tensor(lr)[..., None]
    with torch.no_grad():
        got = model(x)
        want = ref.forward(weights, x, kw)
    assert got.shape == want.shape == (2, 4 * side, 4 * side, 1)
    err = (got - want).abs().max().item()
    assert err <= 2e-5 * max(1.0, want.abs().max().item()), err


def test_the_flagships_parameters_are_the_configurations():
    c = spec.resolve("lfmambax.whole_test")
    assert param_count(make_weights(ref_lfm.param_specs({}), 1, "cpu")) == c.config["params"]


def test_reference_steps_follow_the_trainer():
    """Two steps of the trainer (float32, the small flagship) read from its
    state, against the reference's on the same rows and draws."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.data.datasets import TrainArrays
    from lfsr_tpu_torch.train.trainer import Trainer

    from portbench.reference import train as ref_train

    cfg = Config(compute_dtype="float32", model_kwargs=SMALL, batch_size=2, seed=123)
    weights = make_weights(ref_lfm.param_specs(SMALL), SEED, "cpu")
    lr, hr = data.light_fields(seeds.rng(SEED, "train_pairs"), 8, (32, 32))
    tr = Trainer(cfg, 4, weights, device="cpu")
    follow = checks.Follow(tr, weights, 2)
    with follow:
        tr.run_epoch(TrainArrays(lr=lr, hr=hr), 0)
    got = follow.readings()
    want = ref_train.follow(ref_lfm, weights, lr, hr, kw=SMALL, seed=cfg.seed, steps=2, spe=4,
                            batch=2, loss="composite_v8", hyper=ref_train.Hyper.of(cfg),
                            dropout=True, device="cpu", rows_at_once=1)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k in want["g1"]:
        assert abs(got["g1"][k] - want["g1"][k]) <= 1e-4 * max(want["g1"][k], 1e-3), k
    gaps = checks.train_gaps(got, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-2


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# K1 and K3 at the cells' shapes: K1 at a Synth and a Real whole-scene
# dispatch, K3 at the batch-8 train step; K8 at EPIT's tiled dispatch
K_CASES = {
    "K1": [(4, 518400, 80), (4, 563200, 80)],
    "K3": [(8, 25600, 80)],
    "K8": [(320, 160, 128)],
}


@pytest.mark.parametrize("kid,shape", [(k, s) for k, v in K_CASES.items() for s in v])
def test_counts_reproduce_chip_smoke(kid, shape):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    bf, f32 = torch.bfloat16, torch.float32
    if kid == "K8":
        B, L, D = shape
        args = [_meta(shape, bf) for _ in range(3)] + [_meta((L, L), f32), 8]
        outs = [_meta(shape, bf)]
    else:
        B, L, Di = shape
        R, N = 4, 16
        wdt, bdt, A = _meta((R, Di), f32), _meta((Di,), f32), _meta((Di, N), f32)
        u, dbc = _meta(shape, bf), _meta((B, L, R + 2 * N), bf)
        if kid == "K1":
            args, outs = [u, dbc, wdt, bdt, A, _meta((Di,), f32)], [_meta(shape, bf)]
        else:
            states = _meta((B, -(-L // 64), N, Di), f32)
            args = [u, dbc, _meta(shape, bf), wdt, bdt, A, states]
            outs = [_meta(shape, f32), _meta(shape, f32), _meta((B, L, N), f32),
                    _meta((B, L, N), f32), _meta((B, N, Di), f32)]
    assert counts.work(kid, args, outs) == chip_smoke.work(kid, args, outs)
    ms, by = chip_smoke.bound(kid, args, outs)[:2]
    s, by2 = counts.bound_s(kid, args, outs)
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_whole_scene_padding_and_tiling_match_the_port():
    from lfsr_tpu_torch.ops.tiling import lf_divide, lf_integrate
    from lfsr_tpu_torch.train.evaluate import _whole_pad_batch

    lr, _ = data.light_fields(seeds.rng(SEED, "scenes"), 1, (500 // 4 * 4, 624 // 4 * 4))
    sai = torch.as_tensor(lr[0])
    got, p = _whole_pad_batch(sai[None], 5, 8)
    want, q = common.whole_pad(sai, 5, 8)
    assert p == q and torch.equal(got[0], want)
    assert torch.equal(lf_divide(sai, 5, 32, 16), common.divide(sai, 5, 32, 16))
    patches = torch.randn(common.tile_grid(125, 156, 32, 16)[0] * common.tile_grid(125, 156, 32, 16)[1],
                          5 * 128, 5 * 128)
    assert torch.equal(lf_integrate(patches, 5, 128, 64, 500, 624),
                       common.integrate(patches, 5, 128, 64, 500, 624))

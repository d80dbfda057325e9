"""Checkpoints of the port: an exported JAX checkpoint, the port's own
``.pt`` round trip, and resume against a straight run.

The dryrun flagship (channels 16, d_state 4, phases ((2, 0.25), (1,
None))), float32, batch 2 of 40x40 LR SAI patches.

- JAX: ``Trainer.init_state`` and one ``run_epoch`` (augmentation, masked
  pre-training, dropout), saved by ``save_checkpoint`` (orbax), exported by
  ``scripts/export_npz.py checkpoint``, restored into a port ``Trainer``:
  the forward matches JAX's ``model.apply`` on the restored state within
  test_torch_port_model.py's float32 tolerance (2e-5 absolute); the
  moments equal optax's ``mu``/``nu`` exactly after the bridge's key and
  layout map, and ``count``, ``notfinite_count``, ``last_finite``,
  ``total_notfinite``, the step and the epoch equal JAX's.
- The port: a ``.pt`` written by ``save_checkpoint`` restores every
  parameter, both moments, the counts and the step exactly; ``latest_checkpoint``
  picks the newest; and 2 epochs straight equal 1 epoch + save + restore
  into a fresh trainer + 1 epoch bit for bit (augmentation, masking and
  dropout on: the per-epoch generators).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lfsr_tpu.cli import build_parser, config_from_args
from lfsr_tpu.data.datasets import TrainArrays as JTrainArrays
from lfsr_tpu.train.trainer import Trainer as JTrainer
from lfsr_tpu.train.trainer import save_checkpoint as jsave
from lfsr_tpu_torch.bridge import init_params, state_dict_from_flax
from lfsr_tpu_torch.data.datasets import TrainArrays
from lfsr_tpu_torch.train.trainer import (
    Trainer, latest_checkpoint, restore_checkpoint, save_checkpoint,
)

from _torch_port import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"channels": 16, "d_state": 4, "phases": [[2, 0.25], [1, None]]}
FLAGS = ["--compute_dtype", "float32", "--batch_size", "2", "--epoch", "2",
         "--model_kwargs", json.dumps(SMALL)]
F32_TOL = 2e-5


def _data(n=4):
    rng = np.random.default_rng(7)
    hr = rng.random((n, 160, 160), dtype=np.float32)
    return hr.reshape(n, 40, 4, 40, 4).mean(axis=(2, 4)).astype(np.float32), hr


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX state after one epoch, the exported .npz path)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    jcfg = config_from_args(build_parser().parse_args(FLAGS)).replace(mesh_shape=(1,))
    lr, hr = _data(2)
    tr = JTrainer(jcfg, steps_per_epoch=1)
    key = jax.random.key(3)
    state = tr.init_state(key, lr[:1][..., None])
    state, _ = tr.run_epoch(state, JTrainArrays(lr=lr, hr=hr), 0, key)
    jsave(tmp / "checkpoints", state, 0)
    spec = importlib.util.spec_from_file_location("export_npz", ROOT / "scripts" / "export_npz.py")
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    out = tmp / "epoch_0000.npz"
    assert exporter.main(["checkpoint", str(tmp / "checkpoints" / "epoch_0000"), str(out),
                          *FLAGS]) == 0
    return jcfg, tr, state, out


def _port_cfg():
    from lfsr_tpu_torch.cli import build_parser as pbuild, config_from_args as pconfig

    return pconfig(pbuild().parse_args(FLAGS))


def _trainer(cfg, seed=0, spe=1):
    return Trainer(cfg, spe, init_params(cfg, torch.Generator().manual_seed(seed)), device="cpu")


def test_exported_jax_checkpoint_restores_the_forward(exported):
    jcfg, jtr, state, path = exported
    cfg = _port_cfg()
    tr = _trainer(cfg, seed=5)
    assert restore_checkpoint(path, tr) == 0
    x = np.random.default_rng(2).random((2, 40, 40, 1), dtype=np.float32)
    want = np.asarray(jtr.model.apply(state.variables, jnp.asarray(x)))
    tr.model.eval()
    with torch.no_grad():
        got = tr.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_exported_jax_checkpoint_restores_the_optimizer_state(exported):
    _, _, state, path = exported
    cfg = _port_cfg()
    tr = _trainer(cfg, seed=5)
    restore_checkpoint(path, tr)
    st = state.opt_state
    _, (adam, *_) = st.inner_state
    assert isinstance(adam, optax.ScaleByAdamState)
    params = state_dict_from_flax({"params": state.params}, cfg)
    for name, tree, got in (("params", None, tr.params), ("mu", adam.mu, tr.opt_state.mu),
                            ("nu", adam.nu, tr.opt_state.nu)):
        want = params if tree is None else state_dict_from_flax(tree, cfg)
        assert set(want) == set(got), name
        for k in want:
            np.testing.assert_array_equal(got[k].detach().numpy(), want[k].numpy(),
                                          err_msg=f"{name} {k}")
    ost = tr.opt_state
    assert int(ost.count) == int(adam.count) == 1
    assert int(ost.notfinite_count) == int(st.notfinite_count)
    assert bool(ost.last_finite) == bool(st.last_finite)
    assert int(ost.total_notfinite) == int(st.total_notfinite)
    assert tr.step == int(state.step) == 1


def _state_of(tr):
    st = tr.opt_state
    return {**{k: p.detach().clone() for k, p in tr.params.items()},
            "mu": st.mu_flat.clone(), "nu": st.nu_flat.clone(),
            **{k: getattr(st, k).clone() for k in ("count", "notfinite_count", "last_finite",
                                                   "total_notfinite")}}


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_pt_round_trip_is_exact(tmp_path):
    cfg = _port_cfg()
    lr, hr = _data()
    tr = _trainer(cfg, spe=2)
    tr.run_epoch(TrainArrays(lr, hr), 0)
    tr.opt_state.total_notfinite = tr.opt_state.total_notfinite + 3  # a non-default count
    first = save_checkpoint(tmp_path, tr, 0)
    tr.run_epoch(TrainArrays(lr, hr), 1)
    path = save_checkpoint(tmp_path, tr, 1)
    assert latest_checkpoint(tmp_path) == path == tmp_path / "epoch_0001.pt"
    assert first.name == "epoch_0000.pt" and not list(tmp_path.glob(".*"))
    other = _trainer(cfg, seed=9, spe=2)
    assert restore_checkpoint(path, other) == 1
    _assert_same(_state_of(other), _state_of(tr))
    assert other.step == tr.step == 4


def test_resume_equals_a_straight_run_bit_for_bit(tmp_path):
    cfg = _port_cfg()
    assert cfg.augment and cfg.use_masked_pretrain
    data = TrainArrays(*_data())
    straight = _trainer(cfg, spe=2)
    straight.run_epoch(data, 0)
    straight.run_epoch(data, 1)

    first = _trainer(cfg, spe=2)
    first.run_epoch(data, 0)
    save_checkpoint(tmp_path, first, 0)
    resumed = _trainer(cfg, spe=2)
    assert restore_checkpoint(latest_checkpoint(tmp_path), resumed) == 0
    resumed.run_epoch(data, 1)
    _assert_same(_state_of(resumed), _state_of(straight))
    assert resumed.step == straight.step == 4

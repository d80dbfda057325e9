"""``lfsr_tpu_torch`` and ``chip_smoke.py`` run with the JAX package, jax,
flax and optax blocked.

A fresh interpreter blocks every ``lfsr_tpu``/``jax``/``jaxlib``/``flax``/
``optax``/``h5py``/``orbax`` import (``lfsr_tpu_torch`` is a package of its
own name and passes), imports every module of the port (the trainer,
optimizer, masking, losses and submission tools included), runs a CPU
forward of the small flagship, a tiled and a whole-scene
``evaluate_sets`` (the latter also under ``scan_impl='gated'`` and
``'fused'``), ``infer_submission`` on tiny scenes and one train step,
then a forward and one train step of a one-block EPIT, and checks that no
blocked module was loaded. The machine with the card has none of the
third-party ones, and the port imports nothing of the JAX package. Every
model and trainer is asked for the CPU (``device="cpu"``); the entry points
default to the card. On the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_nojax.py
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CODE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("lfsr_tpu", "jax", "jaxlib", "flax", "optax", "h5py", "orbax")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None


for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())

import numpy as np
import torch
import lfsr_tpu_torch

for mod in pkgutil.walk_packages(lfsr_tpu_torch.__path__, "lfsr_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke  # noqa: F401

from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.data.datasets import TestScene
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.train.evaluate import evaluate_sets

cfg = Config(compute_dtype="float32", whole_scene_for_test=False, patch_size_for_test=8,
             stride_for_test=4,
             model_kwargs={"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))})
model = get_model(cfg, device="cpu")
model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
with torch.inference_mode():
    y = model(torch.rand(2, 40, 40, 1, generator=torch.Generator().manual_seed(1)))
assert y.shape == (2, 160, 160, 1) and torch.isfinite(y).all()
rng = np.random.default_rng(0)
scene = TestScene("toy", "Synthetic", rng.random((40, 40), dtype=np.float32),
                  rng.random((160, 160), dtype=np.float32), np.zeros((160, 160, 2), np.float32))
res = evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=lambda m: None)
assert np.isfinite(res["Synthetic"]["psnr"]), res

import tempfile
from pathlib import Path
from lfsr_tpu_torch.inference import infer_submission

whole = cfg.replace(whole_scene_for_test=None)  # the flagship's default: whole scenes
scenes = [TestScene(f"toy{i}", "Synthetic", rng.random((60, 60), dtype=np.float32),
                    rng.random((240, 240), dtype=np.float32),
                    np.full((240, 240, 2), 0.5, np.float32)) for i in range(2)]
res = evaluate_sets(model, {"Synthetic": scenes}, whole, log=lambda m: None)
assert np.isfinite(res["Synthetic"]["psnr"]), res
for impl in ("gated", "fused"):  # K9b's and K9c's wrappers, their twins on the CPU
    icfg = whole.replace(model_kwargs={**whole.model_kwargs, "scan_impl": impl})
    imodel = get_model(icfg, device="cpu")
    imodel.load_state_dict(init_params(icfg, torch.Generator().manual_seed(0)))
    res = evaluate_sets(imodel, {"Synthetic": scenes}, icfg, log=lambda m: None)
    assert np.isfinite(res["Synthetic"]["psnr"]), (impl, res)
with tempfile.TemporaryDirectory() as tmp:
    rep = infer_submission(model, {"Synth": scenes}, whole, Path(tmp) / "sub", log=lambda m: None)
    assert len(list((Path(tmp) / "sub" / "Synth").rglob("*.bmp"))) == 2 * 25
    assert (Path(tmp) / "sub.zip").exists() and rep.checks > 0
from lfsr_tpu_torch.data.datasets import TrainArrays
from lfsr_tpu_torch.train.trainer import Trainer

tcfg = cfg.replace(batch_size=2, compute_dtype="float32")
trainer = Trainer(tcfg, 1, init_params(tcfg, torch.Generator().manual_seed(0)), device="cpu")
data = TrainArrays(rng.random((2, 40, 40), dtype=np.float32),
                   rng.random((2, 160, 160), dtype=np.float32))
before = trainer.params["HLFR_0.out_scale"].clone()
m = trainer.run_epoch(data, 0)
assert np.isfinite(m["loss"]) and int(trainer.opt_state.count) == 1, m
assert not torch.equal(before, trainer.params["HLFR_0.out_scale"])

ecfg = Config(model_name="EPIT", compute_dtype="float32", batch_size=2,
              model_kwargs={"n_blocks": 1})  # full width: K8's wrapper, its twin on the CPU
emodel = get_model(ecfg, device="cpu")
emodel.load_state_dict(init_params(ecfg, torch.Generator().manual_seed(0)))
with torch.inference_mode():
    y = emodel(torch.rand(1, 40, 40, 1, generator=torch.Generator().manual_seed(2)))
assert y.shape == (1, 160, 160, 1) and torch.isfinite(y).all()
trainer = Trainer(ecfg, 1, init_params(ecfg, torch.Generator().manual_seed(0)), device="cpu")
before = trainer.params["Conv_2.weight"].clone()
m = trainer.run_epoch(data, 0)
assert np.isfinite(m["loss"]) and int(trainer.opt_state.count) == 1, m
assert not torch.equal(before, trainer.params["Conv_2.weight"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("NOJAX-OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    res = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "NOJAX-OK" in res.stdout, res.stdout + res.stderr

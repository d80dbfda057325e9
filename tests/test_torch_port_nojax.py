"""``lfsr_tpu_torch`` and ``chip_smoke.py`` run with jax and flax blocked.

A fresh interpreter blocks every ``jax``/``jaxlib``/``flax`` import, imports
every module of the port, runs a CPU forward of the small flagship, a
tiled and a whole-scene ``evaluate_sets`` and ``infer_submission`` on tiny
scenes, and checks that no jax module was loaded. The machine with the card
has no jax at all.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CODE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax")


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
model = get_model(cfg)
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
with tempfile.TemporaryDirectory() as tmp:
    rep = infer_submission(model, {"Synth": scenes}, whole, Path(tmp) / "sub", log=lambda m: None)
    assert len(list((Path(tmp) / "sub" / "Synth").rglob("*.bmp"))) == 2 * 25
    assert (Path(tmp) / "sub.zip").exists() and rep.checks > 0
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

"""The port's entry points end to end on the CPU, from ``.npz`` files.

``.h5`` training patches and test scenes are written in ``generate.py``'s
transposed layout (as tests/test_e2e.py writes them) and exported by
``scripts/export_npz.py``. The dryrun flagship (channels 16, d_state 4,
phases ((2, 0.25), (1, None))), float32; the NTIRE subsets Real and Synth
at shrunk geometries (LR views 14x10 and 10x10), one scene each, with the
validator's ``EXPECTED_SCENES``/``EXPECTED_DIMS`` shrunk to match, as
tests/test_torch_port_submission.py does.

- ``scripts/train.main``: 2 epochs straight, and 1 epoch then a second run
  of 2 that resumes from ``epoch_0000.pt`` (``--warmup_epochs 2``: the
  schedule of both runs' steps is then the same); the two final
  checkpoints are equal bit for bit; both validate at their last epoch.
- ``scripts/test.main`` on the resumed checkpoint: its CSV equals
  ``evaluate_sets`` on the same model and scenes; every scene's 25 BMPs.
- ``scripts/inference.main``: the gate, the BMP tree, the zip, VALID;
  ``scripts/validate_submission.main`` exits 0 on it;
  ``scripts/check_efficiency.main --json`` exits 0.
- Against JAX: ``test.main`` of the JAX package on the ``.h5`` scenes with
  a JAX orbax checkpoint, and the port's ``test.main`` on the exported
  scenes and checkpoint: per-scene PSNR within 1e-3 dB, SSIM within 1e-5
  (float32 sums in another order; the CSVs keep 6 decimals), every BMP
  byte within 1 (RGB truncated to uint8 after float rounding).
"""

import contextlib
import csv
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lfsr_tpu.cli import build_parser as jbuild_parser
from lfsr_tpu.cli import config_from_args as jconfig_from_args
from lfsr_tpu.data.generate import _write_h5
from lfsr_tpu.train.trainer import Trainer as JTrainer
from lfsr_tpu.train.trainer import save_checkpoint as jsave
from lfsr_tpu_torch.cli import build_parser, config_from_args
from lfsr_tpu_torch.data.datasets import load_test_scenes
from lfsr_tpu_torch.scripts import check_efficiency, inference, test, train, validate_submission
from lfsr_tpu_torch.tools import submission as tsub
from lfsr_tpu_torch.tools.bmp import decode_bmp, parse_header
from lfsr_tpu_torch.train.evaluate import evaluate_sets
from lfsr_tpu_torch.train.trainer import load_params

from _torch_port import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ANG, S = 5, 4
SMALL = {"channels": 16, "d_state": 4, "phases": [[2, 0.25], [1, None]]}
LR_VIEWS = {"Real": (14, 10), "Synth": (10, 10)}  # (h0, w0)
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """.h5 trees and their .npz exports: 4 training patches, one scene a subset."""
    tmp = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(3)
    tag = f"SR_{ANG}x{ANG}_{S}x"
    for i in range(4):
        hr = rng.random((ANG * 32 * S, ANG * 32 * S), dtype=np.float32)
        lr = hr.reshape(ANG * 32, S, ANG * 32, S).mean((1, 3))
        _write_h5(tmp / "h5_train" / tag / "SynthSet" / f"{i + 1:06d}.h5", Lr_SAI_y=lr, Hr_SAI_y=hr)
    for subset, (h0, w0) in LR_VIEWS.items():
        hr = rng.random((ANG * h0 * S, ANG * w0 * S), dtype=np.float32)
        _write_h5(tmp / "h5_test" / tag / subset / "scene_00.h5",
                  Lr_SAI_y=hr.reshape(ANG * h0, S, ANG * w0, S).mean((1, 3)), Hr_SAI_y=hr,
                  Sr_SAI_cbcr=0.25 + 0.5 * rng.random((*hr.shape, 2), dtype=np.float32))
    exporter = _load("export_npz", ROOT / "scripts" / "export_npz.py")
    for kind in ("train", "test"):
        assert exporter.main([kind, str(tmp / f"h5_{kind}"), str(tmp / f"npz_{kind}")]) == 0
    return tmp


@pytest.fixture
def small_ntire(monkeypatch):
    monkeypatch.setattr(tsub, "EXPECTED_SCENES", {"Real": 1, "Synth": 1})
    monkeypatch.setattr(tsub, "EXPECTED_DIMS", {k: (w * S, h * S) for k, (h, w) in
                                                LR_VIEWS.items()})


def _flags(tmp, log, *extra):
    return ["--compute_dtype", "float32", "--batch_size", "2", "--model_kwargs", json.dumps(SMALL),
            "--path_for_train", str(tmp / "npz_train"), "--path_for_test", str(tmp / "npz_test"),
            "--path_log", str(tmp / log), *extra]


def _cfg(argv):
    return config_from_args(build_parser().parse_args(argv))


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def trained(roots):
    """The resumed and the straight run's final checkpoints and configs."""
    runs = {}
    for name, epochs in (("straight", ["2"]), ("resumed", ["1", "2"])):
        for e in epochs:
            cfg = _cfg(_flags(roots, f"log_{name}", "--epoch", e, "--warmup_epochs", "2"))
            tr = train.main(cfg, device="cpu")
        runs[name] = (cfg, tr)
    return runs


def test_train_resume_equals_a_straight_run(trained):
    (cfg, straight), (rcfg, resumed) = trained["straight"], trained["resumed"]
    assert straight.step == resumed.step == 4
    base = Path(rcfg.path_log) / rcfg.task_tag() / "ALL" / "LFMambaX"
    assert sorted(p.name for p in (base / "checkpoints").iterdir()) == ["epoch_0000.pt",
                                                                        "epoch_0001.pt"]
    a = torch.load(base / "checkpoints" / "epoch_0001.pt", weights_only=True)
    b = torch.load(Path(cfg.path_log) / cfg.task_tag() / "ALL" / "LFMambaX" / "checkpoints" /
                   "epoch_0001.pt", weights_only=True)
    assert a.keys() == b.keys() and a["epoch"] == b["epoch"] == 1
    for k in a:
        if isinstance(a[k], dict):
            assert all(torch.equal(a[k][n], b[k][n]) for n in a[k]), k
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    log = (base / "LFMambaX.txt").read_text()
    assert "resumed from" in log and "epoch 001: loss" in log and "training complete" in log
    for ep in ("000", "001"):  # each run validated at its last epoch
        rows = _csv(base / "results" / f"evaluation_epoch{ep}.csv")
        assert rows[0] == ["Datasets", "Scenes", "PSNR", "SSIM"] and len(rows) == 5


def test_test_script_csv_equals_evaluate_sets(trained, roots):
    cfg, _ = trained["resumed"]
    test.main(cfg, device="cpu")
    results = Path(cfg.path_log) / cfg.task_tag() / "ALL" / "LFMambaX" / "results"
    rows = _csv(results / "evaluation.csv")
    model = test.load_model(cfg, results.parent / "checkpoints", None, lambda m: None, "cpu")[0]
    scenes = load_test_scenes(cfg.path_for_test, ANG, S)
    want = evaluate_sets(model, scenes, cfg.replace(whole_scene_minibatch=1), log=lambda m: None)
    expect = [["Datasets", "Scenes", "PSNR", "SSIM"]]
    for ds, r in want.items():
        for name, p, s in [*r["scenes"], ("average", r["psnr"], r["ssim"])]:
            expect.append([ds, name, f"{p:.6f}", f"{s:.6f}"])
    assert rows == expect
    for subset, (h0, w0) in LR_VIEWS.items():
        bmps = sorted((results / subset / "scene_00").glob("View_*.bmp"))
        assert len(bmps) == ANG * ANG
        hdr = parse_header(bmps[0].read_bytes())
        assert (hdr["width"], hdr["height"]) == (w0 * S, h0 * S)


def test_inference_writes_a_valid_submission(trained, tmp_path, small_ntire, capsys):
    cfg, _ = trained["resumed"]
    zip_path = inference.main(cfg, out_root=str(tmp_path / "sub"), device="cpu")
    assert zip_path == tmp_path / "sub.zip" and zip_path.exists()
    assert len(list((tmp_path / "sub").rglob("View_*.bmp"))) == 2 * ANG * ANG
    log = next(Path(cfg.path_log).rglob("LFMambaX_infer.txt")).read_text()
    assert "VERDICT: PASS" in log and "VALID (" in log and "loaded checkpoint" in log
    assert validate_submission.main([str(zip_path)]) == 0
    flags = ["--compute_dtype", "float32", "--model_kwargs", json.dumps(SMALL)]
    capsys.readouterr()
    assert check_efficiency.main([*flags, "--json"], device="cpu") == 0
    report = json.loads(capsys.readouterr().out)
    assert report["verdict"] and report["params"] == 21_524


def test_test_on_a_jax_checkpoint_matches_jax_test(roots, tmp_path):
    """JAX's test.main on .h5 and a JAX orbax checkpoint; the port's on the
    exported .npz scenes and checkpoint."""
    jargv = ["--compute_dtype", "float32", "--model_kwargs", json.dumps(SMALL),
             "--path_for_test", str(roots / "h5_test"), "--path_log", str(tmp_path / "jax")]
    jcfg = jconfig_from_args(jbuild_parser().parse_args(jargv)).replace(mesh_shape=(1,))
    jtr = JTrainer(jcfg, steps_per_epoch=1)
    state = jtr.init_state(jax.random.key(4), np.zeros((1, 160, 160, 1), np.float32))
    ckpt = jsave(tmp_path / "orbax", state, 3)
    with contextlib.redirect_stdout(io.StringIO()):
        _load("lfsr_test_cli", ROOT / "test.py").main(jcfg, str(ckpt))
    npz = tmp_path / "epoch_0003.npz"
    exporter = _load("export_npz", ROOT / "scripts" / "export_npz.py")
    assert exporter.main(["checkpoint", str(ckpt), str(npz), *jargv[:4]]) == 0

    cfg = _cfg(["--compute_dtype", "float32", "--model_kwargs", json.dumps(SMALL),
                "--path_for_test", str(roots / "npz_test"), "--path_log", str(tmp_path / "port")])
    assert load_params(npz, cfg)[1] == 3
    test.main(cfg, str(npz), device="cpu")
    res = {}
    for side in ("jax", "port"):
        res[side] = next((tmp_path / side).rglob("results"))
    want, got = _csv(res["jax"] / "evaluation.csv"), _csv(res["port"] / "evaluation.csv")
    assert [r[:2] for r in got] == [r[:2] for r in want] and len(got) == 5
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g[2]) - float(w[2])) <= PSNR_TOL, (g, w)
        assert abs(float(g[3]) - float(w[3])) <= SSIM_TOL, (g, w)
    jbmps = sorted(res["jax"].rglob("*.bmp"))
    assert len(jbmps) == 2 * ANG * ANG
    for f in jbmps:
        g = (res["port"] / f.relative_to(res["jax"])).read_bytes()
        w = f.read_bytes()
        assert parse_header(g) == parse_header(w), f
        d = np.abs(decode_bmp(g).astype(int) - decode_bmp(w).astype(int))
        assert d.max() <= 1, (f, d.max())

"""The benchmark's harness on the CPU: every cell resolves and rehearses a
run at a small size, the contract's names and units hold, nothing under
``portbench/`` imports JAX or the JAX package, a throwaway cell, mix and
metric are added by files alone, and faults planted in the program turn
``correct`` false.

    python -m pytest portbench/tests -q
"""

import ast
import copy
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
# each cell at a size the CPU runs in seconds, in float32 (the reference then
# agrees to float32's rounding, and the limits, set for bfloat16 in units of
# its rounding, hold in units of float32's)
TINY = {
    "lfmambax.whole_test": {
        "config": {"compute_dtype": "float32", "model_kwargs": SMALL},
        "traffic": {"geometries": [{"subset": "Synth", "hr": [40, 40], "scenes": 4},
                                   {"subset": "Real", "hr": [40, 56], "scenes": 4}],
                    "check_scenes": {"Synth": 1, "Real": 1}, "trace_chunks": 1}},
    "lfmambax.train_b8": {
        "config": {"compute_dtype": "float32", "model_kwargs": SMALL, "batch_size": 2},
        "traffic": {"pairs": 8, "hr_view": 32, "check_steps": 2, "trace_steps": [1, 1]}},
}
SEED = 2**31 + 11  # more than 32 signed bits hold


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def rehearse(cell, trace=0, root=ROOT, overrides=None, capsys=None, seconds=0.5):
    over = copy.deepcopy(overrides or TINY[cell])
    result = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", overrides=over, root=root)
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        assert json.loads(out[-1]) == json.loads(json.dumps(result))
    return result


def test_the_tiny_sizes_cover_every_cell():
    assert set(CELLS) <= set(TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    assert c.config["reference"] and (BENCH / "reference" / f"{c.config['reference']}.py").exists()
    assert c.traffic["loop"] in ("scenes", "train")
    for m in c.end_to_end:
        assert m["name"] == "setup_s" or m["name"] in c.traffic["statistics"]
    assert len(c.end_to_end) >= 2 and any(m["name"] == "setup_s" for m in c.end_to_end)
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(c, m["name"]).read)
    assert c.limits and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_a_well_formed_last_line(cell, trace, capsys):
    r = rehearse(cell, trace, capsys=capsys)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    c = spec.resolve(cell)
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    # on the CPU no kernel runs: the rooflines find nothing and are left out
    got = set(r["metrics"])
    assert got <= set(want) and got >= {n for n in want if "roofline" not in n}
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert set(r["check"]) == set(c.limits)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


def test_names_and_units_keep_to_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
    assert all(line(w) for w in b["command"]) and len(b["command"]) <= 32
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and (ROOT / c["file"]).exists()
        assert all(name.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["config"]) and name.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names)) and len(set(w["name"] for w in b["workloads"])) == len(CELLS)
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        # the metric it moves is reported in every cell that reports it
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    assert len(json.dumps(b).encode()) <= 64 * 1024


def _top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level module names compared whole: lfsr_tpu_torch is not lfsr_tpu."""
    files = list(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not _top_level_imports(f) & {"jax", "jaxlib", "flax", "lfsr_tpu"}, f
    for f in (BENCH / "reference").rglob("*.py"):  # the reference uses nothing of the program
        assert "lfsr_tpu_torch" not in _top_level_imports(f), f


def test_the_top_level_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "lfsr_tpu_torch_like", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lfsr_tpu.ops", types.ModuleType("y"))
    assert run.forbidden_modules() == ["lfsr_tpu"]


@pytest.mark.parametrize("cell", CELLS)
def test_jax_loaded_by_the_check_stops_the_run(cell, monkeypatch, capsys):
    """The look for JAX comes after the reference's check, just before the
    result: a module of JAX loaded there ends the run with code 3 and
    nothing on standard output."""
    import sys
    import types

    from portbench.harness import loops

    cls = loops.LOOPS[spec.resolve(cell).traffic["loop"]]
    check = cls.check

    def check_loading_jax(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(self, *a, **k)

    monkeypatch.setattr(cls, "check", check_loading_jax)
    with pytest.raises(SystemExit) as e:
        rehearse(cell)
    assert e.value.code == 3
    cap = capsys.readouterr()
    assert cap.out == "" and "['jax']" in cap.err


# the scenes loop's two evaluation paths: "whole" (the whole-scene cell's) and
# "tiled" (overlapping LR patches, the reference protocol), chosen by the mix
PATHS = {"whole": {},
         "tiled": {"whole_scene_for_test": False, "patch_size_for_test": 8, "stride_for_test": 4}}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_cell_a_mix_and_a_metric_are_added_by_files_alone(tmp_path, path):
    """A throwaway configuration entry, traffic mix, limits and per-layer
    metric, added as new files and entries beside copies of the existing
    ones, which no line of the harness has to name; the mix takes either
    evaluation path."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "lfmambax_tiny", "source": "https://example.org/tiny",
                         "file": "portbench/configs/lfmambax_tiny.json", "reduced": ["channels"],
                         "why": "a throwaway entry"})
    cfg = json.loads((BENCH / "configs" / "lfmambax.json").read_text())
    cfg.update(config={"model_name": "LFMambaX", "compute_dtype": "float32",
                       "model_kwargs": {"channels": 16, "d_state": 4}}, params=None)
    (tmp_path / "portbench/configs/lfmambax_tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "whole_test.json").read_text())
    traffic.update(path=path, config=PATHS[path],
                   geometries=[{"subset": "Tiny", "hr": [40, 40], "scenes": 2}],
                   check_scenes={"Tiny": 1}, trace_chunks=1,
                   statistics={"tiny_scenes_per_s": "units_per_s"})
    (tmp_path / "portbench/traffic/tiny_whole.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/limits/lfmambax_tiny.tiny_whole.json").write_text('{"sr_gap": 5.0}')
    (tmp_path / "portbench/metrics/scenes_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['units'])\n")
    b["workloads"].append({"name": "lfmambax_tiny.tiny_whole", "config": "lfmambax_tiny",
                           "traffic": "tiny_whole", "chips": 1, "why": "a throwaway cell"})
    b["end_to_end"].append({"name": "tiny_scenes_per_s", "unit": "scenes/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["lfmambax_tiny.tiny_whole"]})
    b["per_layer"].append({"name": "scenes_seen.tiny", "unit": "scenes", "better": "higher",
                           "source": "host_clock", "layer": "Host path",
                           "moves": "tiny_scenes_per_s", "workloads": ["lfmambax_tiny.tiny_whole"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    over = {"config": {}, "traffic": {}}
    r0 = rehearse("lfmambax_tiny.tiny_whole", 0, root=tmp_path, overrides=over)
    r1 = rehearse("lfmambax_tiny.tiny_whole", 1, root=tmp_path, overrides=over)
    assert set(r0["metrics"]) == {"tiny_scenes_per_s", "setup_s"} and r0["correct"]
    assert r1["metrics"]["scenes_seen.tiny"]["value"] == r1["attempted"] > 0


# faults planted in the program underneath a run: each turns correct false


def _perturbed(forward):
    def wrong(self, *a, **k):
        out = forward(self, *a, **k)
        return out + 1e-3 * (out.detach().reshape(-1)[:1] * 0 + 1)
    return wrong


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    from lfsr_tpu_torch.models import lfmambax

    cls = lfmambax.LFMambaX
    monkeypatch.setattr(cls, "forward", _perturbed(cls.forward))
    r = rehearse("lfmambax.whole_test")
    assert r["correct"] is False and r["check"]["sr_gap"]["value"] > r["check"]["sr_gap"]["limit"]


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    from lfsr_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step_", lambda self, params, grads, state: None)
    r = rehearse("lfmambax.train_b8")
    assert r["correct"] is False
    # no first moment and no change: every leaf's gap is 1, or its norm over
    # the median leaf's where that is larger
    assert r["check"]["grad_gap"]["value"] > 0.9 and r["check"]["change_gap"]["value"] > 0.9


def test_one_leaf_left_unmoved_fails(monkeypatch):
    """A step that updates every leaf but one: the change's worst leaf
    reads about 1, the other numbers may pass."""
    from lfsr_tpu_torch.train import optim

    step_ = optim.Optimizer.step_

    def frozen(self, params, grads, state):
        leaf = max(params, key=lambda k: params[k].numel())
        before = params[leaf].detach().clone()
        step_(self, params, grads, state)
        with torch.no_grad():
            params[leaf].copy_(before)

    monkeypatch.setattr(optim.Optimizer, "step_", frozen)
    r = rehearse("lfmambax.train_b8")
    assert r["correct"] is False
    assert r["check"]["change_gap"]["value"] > 0.9 > r["check"]["change_gap"]["limit"]


def test_half_of_the_batch_left_out_fails(monkeypatch):
    from lfsr_tpu_torch.train import trainer

    get_loss = trainer.get_loss

    def half(cfg):
        loss = get_loss(cfg)
        return lambda sr, hr: loss(sr[: sr.shape[0] // 2], hr[: hr.shape[0] // 2])

    monkeypatch.setattr(trainer, "get_loss", half)
    r = rehearse("lfmambax.train_b8")
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["check"].values())

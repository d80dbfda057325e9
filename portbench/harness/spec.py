"""What a cell is made of, found by name from ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's file (``configs/<name>.json``, as ``BENCHMARK.json`` gives
it) holds the model's registry name, its ``Config`` fields and widths; the
traffic mix is ``traffic/<name>.json``, parameters read by one of the
general loops in ``harness/loops.py`` (its ``"loop"`` key); the limits of
the cell's correctness check are ``limits/<cell>.json``; a per-layer
metric ``<family>.<suffix>`` is read by ``metrics/<family>.py``. Adding a
cell, a configuration, a mix or a metric adds files and entries and edits
none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration's file
    traffic_name: str
    traffic: dict         # the traffic mix's file
    end_to_end: list      # the BENCHMARK.json metrics this cell reports, --trace 0
    per_layer: list       # ... and --trace 1
    limits: dict = field(default_factory=dict)
    bench_dir: Path = BENCH_DIR  # where its traffic, limits and metric readers lie


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell called ``name`` of ``root``'s BENCHMARK.json, with its files
    read (from ``root/portbench``). Raises KeyError for an unknown cell and
    FileNotFoundError for a missing file."""
    root = Path(root)
    bench_dir = root / BENCH_DIR.name
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    with open(root / cfgs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    limits_file = bench_dir / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic, e2e, layer,
                limits, bench_dir)


def reader(cell: Cell, metric_name: str):
    """The reader module of per-layer metric ``<family>.<suffix>``:
    ``metrics/<family>.py`` of the cell's benchmark folder."""
    family = metric_name.split(".")[0]
    path = cell.bench_dir / "metrics" / f"{family}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench.metrics.{family}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod

"""LF-DET's cell on the CPU: its configuration, its files, the reference's
independence and K15's count and roofline reader.

    python -m pytest portbench/tests -q

``TINY_LFDET`` is the cell's small size (16 channels, one mix block, patch
8 / stride 4: MacPI 40, so the 15-wide windows take the edge path) in the
cell's own bfloat16, so ``sr_gap`` reads in the units its limit was set in.
Importing this module adds it to the harness tests' table of small sizes
(``test_portbench_harness.TINY``), as ``conftest.py`` adds LFT's, so their
rehearsals run the cell: pytest imports every test module of the folder
before it runs any.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.counts import dense_attention as counts
from portbench.harness import spec
from portbench.harness.trace import Operand
from portbench.harness.weights import make_weights, param_count
from portbench.reference import lf_det as ref_lf_det
from portbench.tests import test_portbench_harness

CELL = "lfdet.tiled_test"
TINY_LFDET = {
    "config": {"compute_dtype": "bfloat16", "model_kwargs": {"channels": 16, "depth": 1},
               "patch_size_for_test": 8, "stride_for_test": 4, "minibatch_for_test": 4},
    "traffic": {"geometries": [{"subset": "Synth", "hr": [40, 40], "scenes": 2},
                               {"subset": "Real", "hr": [40, 56], "scenes": 2}],
                "check_scenes": {"Synth": 1, "Real": 1}, "trace_chunks": 1}}
test_portbench_harness.TINY.setdefault(CELL, TINY_LFDET)
METRICS = ("idle_share", "mfu", "launches", "torch_ops_ms", "spa_torch_ms", "ang_torch_ms",
           "k15_roofline", "k13_roofline", "engine_ms", "h2d_copies", "ends_torch_ms")


def test_the_references_parameters_are_the_configurations():
    c = spec.resolve(CELL)
    assert c.config["model"] == "LF_DET" and c.config["reference"] == "lf_det"
    assert param_count(make_weights(ref_lf_det.param_specs({}), 1, "cpu")) == c.config["params"]
    assert c.config["params"] == 1_686_668 and c.config["reduced"] == []


def test_the_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse(Path(ref_lf_det.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "torch", "portbench"}, names


def test_the_cell_resolves_with_every_file():
    c = spec.resolve(CELL)
    assert c.chips == 1 and c.traffic_name == "tiled_test" and c.traffic["path"] == "tiled"
    assert [m["name"] for m in c.end_to_end] == ["whole_scenes_per_s", "setup_s"]
    assert [m["name"] for m in c.per_layer] == [f"{m}.lfdet_tiled" for m in METRICS]
    for m in c.per_layer:
        assert callable(spec.reader(c, m["name"]).read)
    assert set(c.limits) == {"sr_gap"}
    for other in ("lfmambax.whole_test", "lfmambax.train_b8", "lft.tiled_test"):
        assert not any(m["name"].endswith(".lfdet_tiled") for m in spec.resolve(other).per_layer)


def _op(shape, dtype="bfloat16"):
    return Operand(tuple(shape), f"torch.{dtype}", 2 if dtype == "bfloat16" else 4)


def _call(B, Lq, Lk, dtype="bfloat16"):
    q, kv = _op((B, Lq, 64), dtype), _op((B, Lk, 64), dtype)
    return [q, kv, kv, 4], [q]


def test_k15_count_by_hand():
    """Two sequences, 3 queries, 5 keys, D 64 (4 heads of 16), bf16: q and o
    2 * 3 * 64 values, k and v 2 * 5 * 64, 2 bytes each; products 4 * 2 * 3 *
    5 * 64; one exponential a (query, key, head): 2 * 4 * 3 * 5."""
    args, outs = _call(2, 3, 5)
    assert counts.work(args, outs) == ((2 * 384 + 2 * 640) * 2, 4.0 * 2 * 3 * 5 * 64, 120.0)
    # the cell's four sites of a 16-tile call, by hand: bytes set each bound
    sites = {(400, 1024, 256): 2 * (400 * 1024 + 400 * 256) * 64 * 2,
             (16384, 25, 25): 4 * 16384 * 25 * 64 * 2,
             (4096, 100, 100): 4 * 4096 * 100 * 64 * 2,
             (1936, 225, 225): 4 * 1936 * 225 * 64 * 2}
    total = 0.0
    for (B, Lq, Lk), nbytes in sites.items():
        s, by = counts.bound_s(*_call(B, Lq, Lk))
        assert by == "bytes" and s == pytest.approx(nbytes / 3.35e12)
        total += s * (2 if Lq == 1024 else 1)  # two spatial blocks to each window size
    assert 4 * total * 1e3 == pytest.approx(1.0793, abs=1e-3)  # ms a forward, 4 mix blocks
    f = _call(400, 1024, 256, "float32")
    assert counts.bound_s(*f)[0] == pytest.approx(2 * counts.bound_s(*_call(400, 1024, 256))[0])


@pytest.mark.parametrize("B,Lq,Lk", [(400, 1024, 256), (16384, 25, 25), (4096, 100, 100),
                                     (1936, 225, 225)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_count_is_chip_smokes(B, Lq, Lk, dtype):
    """``chip_smoke.work`` / ``bound`` of K15 at the cell's four sites (k and
    v the two halves of one projection) equal this count."""
    import sys

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    dt = getattr(torch, dtype)
    q = torch.empty(B, Lq, 64, dtype=dt, device="meta")
    kv = torch.empty(B, Lk, 128, dtype=dt, device="meta")
    args, outs = (q, kv[..., :64], kv[..., 64:], 4), [q]
    assert chip_smoke.work("K15", args, outs) == counts.work(args, outs)
    ms, by = chip_smoke.bound("K15", args, outs)[:2]
    s, by2 = counts.bound_s(args, outs)
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_the_roofline_reads_its_spans_alone():
    reader = spec.reader(spec.resolve(CELL), "k15_roofline.lfdet_tiled")
    call = _call(400, 1024, 256)
    least = counts.bound_s(*call)[0]
    kernels = [("dense_mha_mma_kernel", least * 2, "K15"), ("dense_mha_mma_kernel", least * 2, "K15"),
               ("Memcpy DtoD", 1.0, "K15"), ("layer_norm_kernel", 5.0, "K13"), ("other", 5.0, None)]
    trace = SimpleNamespace(calls={"K15": [call, call]}, kernels=kernels)
    assert reader.read({"trace": trace}) == pytest.approx(50.0)
    # a program without K15 launches none: nothing to read
    assert reader.read({"trace": SimpleNamespace(calls={}, kernels=kernels[3:])}) is None


def test_the_reference_counts_a_16_tile_call():
    """``FlopCounterMode`` over the reference on the meta device, as
    ``counts/model_flops.py`` counts ``mfu.lfdet_tiled``: 1.6271 TFLOP a
    call of 16 tiles of 5 x 5 views of 32 x 32 (PERF.md section 3)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    p = {k: torch.empty(s, device="meta") for k, (s, _) in ref_lf_det.param_specs({}).items()}
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref_lf_det.forward(p, torch.empty((16, 160, 160, 1), device="meta"), {})
    assert fc.get_total_flops() == 1_627_148_697_600

"""LFT's cell on the CPU: its configuration, its files and K12's count.

    python -m pytest portbench/tests -q

``TINY_LFT`` is the cell's small size (16 channels, one block, patch 8 /
stride 4) in the cell's own bfloat16, so ``sr_gap`` reads in the units its
limit was set in (in float32 the unit is float32's rounding, and LFT's
attentions and LayerNorms part from the reference by several of those):
``conftest.py`` adds it to the harness tests' table of small sizes, so
their rehearsals (``test_rehearsal_prints_a_well_formed_last_line``, at
trace 0 and 1) run the cell.
"""

import pytest

from portbench.counts import local_attention as counts
from portbench.harness import spec
from portbench.harness.trace import Operand
from portbench.harness.weights import make_weights, param_count
from portbench.reference import lft as ref_lft

CELL = "lft.tiled_test"
TINY_LFT = {
    "config": {"compute_dtype": "bfloat16", "model_kwargs": {"channels": 16, "n_blocks": 1},
               "patch_size_for_test": 8, "stride_for_test": 4, "minibatch_for_test": 4},
    "traffic": {"geometries": [{"subset": "Synth", "hr": [40, 40], "scenes": 2},
                               {"subset": "Real", "hr": [40, 56], "scenes": 2}],
                "check_scenes": {"Synth": 1, "Real": 1}, "trace_chunks": 1}}


def test_the_references_parameters_are_the_configurations():
    c = spec.resolve(CELL)
    assert c.config["model"] == "LFT" and c.config["reference"] == "lft"
    assert param_count(make_weights(ref_lft.param_specs({}), 1, "cpu")) == c.config["params"]
    assert c.config["params"] == 1_163_392 and c.config["reduced"] == []


def test_the_cell_resolves_with_every_file():
    c = spec.resolve(CELL)
    assert c.chips == 1 and c.traffic["path"] == "tiled"
    assert c.traffic["config"] == {"patch_size_for_test": 32, "stride_for_test": 16,
                                   "minibatch_for_test": 16}
    assert [m["name"] for m in c.end_to_end] == ["whole_scenes_per_s", "setup_s"]
    names = [m["name"] for m in c.per_layer]
    assert len(names) == 11 and all(n.endswith(".lft_tiled") for n in names)
    for n in names:
        assert callable(spec.reader(c, n).read)
    assert set(c.limits) == {"sr_gap"}
    # the flagship's cells report none of the new metrics
    for other in ("lfmambax.whole_test", "lfmambax.train_b8"):
        assert not any(m["name"].endswith(".lft_tiled") for m in spec.resolve(other).per_layer)


def _op(shape, dtype):
    return Operand(tuple(shape), f"torch.{dtype}", 2 if dtype == "bfloat16" else 4)


def test_k12_count_by_hand():
    """Two 3 x 4 images, 2 heads of 8, a 3 x 3 window, bf16: 4 tensors of
    2 * 12 * 16 values, 2 bytes each; products 4 * 24 tokens * 9 slots * 16
    channels; softmax 4 * 24 tokens * 2 heads * 9 slots."""
    q = _op((2, 12, 16), "bfloat16")
    args, outs = [q, q, q, 2, 3, 4, 3, 3], [q]
    assert counts.work(args, outs) == (4 * 2 * 12 * 16 * 2, 4.0 * 24 * 9 * 16, 4.0 * 24 * 2 * 9)
    s, by = counts.bound_s(args, outs)
    assert by == "bytes" and s == pytest.approx(3072 / 3.35e12)
    # LFT's tiled call: 419 MB, 0.125 ms
    q = _op((400, 1024, 128), "bfloat16")
    s, by = counts.bound_s([q, q, q, 8, 32, 32, 5, 5], [q])
    assert by == "bytes" and s * 1e3 == pytest.approx(4 * 400 * 1024 * 128 * 2 / 3.35e9)
    f = _op((400, 1024, 128), "float32")
    assert counts.bound_s([f, f, f, 8, 32, 32, 5, 5], [f])[0] == pytest.approx(2 * s)

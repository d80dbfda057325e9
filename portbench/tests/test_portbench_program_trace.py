"""The per-layer metrics that read the program's own spans and counters
(``lfsr_tpu_torch.trace``), in a CPU rehearsal of each cell with
``--trace 1``: each is reported, finite and not negative, and the copies
counted at the upload sites come out at the rehearsal's worked-out value.

    python -m pytest portbench/tests -m 'not gpu'
"""

import math

import pytest

from portbench.harness import spec
from portbench.tests.test_portbench_harness import SMALL, TINY, rehearse

PROGRAM = {
    "lfmambax.whole_test": ("blocks_torch_ms.whole", "outer_torch_ms.whole", "engine_ms.whole",
                            "h2d_copies.whole"),
    "lfmambax.train_b8": ("forward_host_ms.train", "backward_host_ms.train",
                          "optimizer_host_ms.train", "h2d_copies.train"),
}


def _copies(cell: str) -> float:
    """The copies a unit makes at the rehearsal's sizes. The small flagship
    has 3 blocks and one window attention. Whole: the traced chunk is one
    geometry group of 4 scenes in one dispatch, which uploads the group
    once and makes hi, wi, the window index table and the folded out-conv
    matrix. Train: the traced step (the profiler starts inside it, after
    its draw) scales dropout in each block and uploads the window index
    table and the folded matrix; its view mask, whose draw copies three
    more, was drawn before."""
    blocks = sum(n for n, _ in SMALL["phases"])
    attn = sum(a is not None for _, a in SMALL["phases"])
    if cell == "lfmambax.whole_test":
        scenes = TINY[cell]["traffic"]["geometries"][0]["scenes"]
        return (1 + 2 + attn + 1) / scenes
    return float(blocks + attn + 1)


@pytest.mark.parametrize("cell", sorted(PROGRAM))
def test_the_program_trace_metrics_read_in_a_rehearsal(cell):
    c = spec.resolve(cell)
    assert set(PROGRAM[cell]) <= {m["name"] for m in c.per_layer}
    r = rehearse(cell, 1)
    for name in PROGRAM[cell]:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert r["metrics"][PROGRAM[cell][-1]]["value"] == pytest.approx(_copies(cell), abs=1e-12)
    # the device's time of the blocks and of the rest of the forward (the
    # host's, on the CPU) is spent
    if cell == "lfmambax.whole_test":
        assert r["metrics"]["blocks_torch_ms.whole"]["value"] > 0
        assert r["metrics"]["outer_torch_ms.whole"]["value"] > 0

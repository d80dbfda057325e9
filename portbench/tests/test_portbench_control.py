"""The comparison that decides ``correct`` fails its control.

The control is the plain reference put in the program's place and computed
in the precision below the configuration's (float8 e4m3 for a bfloat16
model, ``reference.common.Prec``). On the card (marker ``gpu``), each cell
at its own size and seed: the program's numbers keep to the cell's limits
and the control's break at least one. On the CPU, the same readings at a
small float32 size (control: bfloat16): the control reads far above the
program. Run on the card from the root of a checkout:

    python -m pytest -p no:cacheprovider -m gpu portbench/tests/test_portbench_control.py
"""

import copy

import pytest
import torch

from portbench import calibrate
from portbench.harness import spec
from portbench.tests.test_portbench_harness import CELLS, TINY

SEED = 7_000_000_001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in numbers.items())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    c = spec.resolve(cell)
    train = c.traffic["loop"] == "train"
    r = calibrate.readings(c, SEED, 0.0 if train else 4.0, True, None)
    assert not _fails(r["program"], c.limits), r
    assert _fails(r["control"], c.limits), r


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program_on_the_cpu(cell):
    c = spec.resolve(cell)
    tiny = copy.deepcopy(TINY[cell])
    c.traffic.update(tiny["traffic"])
    r = calibrate.readings(c, SEED, 0.5, True, None, device="cpu", overrides=tiny["config"])
    assert not _fails(r["program"], c.limits), r
    for k, v in r["control"].items():
        assert v > r["program"][k], (k, r)

"""Test-scene record of the port: a jax-free twin of
``lfsr_tpu.data.datasets.TestScene`` (same fields). Loading ``.h5`` test
sets is not ported yet."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TestScene:
    __test__ = False  # a data record, not a pytest class

    name: str
    dataset: str
    lr_y: np.ndarray  # [A*h, A*w]
    hr_y: np.ndarray  # [A*H, A*W]
    sr_cbcr: np.ndarray  # [A*H, A*W, 2]

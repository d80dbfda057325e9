"""Data records and in-step augmentation of the port (jax-free twins of
``lfsr_tpu.data.datasets``).

- ``TestScene`` and ``TrainArrays``: the same fields as the JAX records.
- ``augment_batch``: per item, an independent 50% W-flip, H-flip and
  transpose of the whole SAI mosaic (the LF U<->V + H<->W transpose), the
  same for LR and HR; split into ``draw_augment`` (flags from a
  ``torch.Generator`` on its device) and ``apply_augment``.
- ``batch_indices``: an epoch of shuffled batch indices from
  ``torch.randperm``; ``tile_indices`` is its deterministic half.

Loading ``.h5`` training and test sets is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class TestScene:
    __test__ = False  # a data record, not a pytest class

    name: str
    dataset: str
    lr_y: np.ndarray  # [A*h, A*w]
    hr_y: np.ndarray  # [A*H, A*W]
    sr_cbcr: np.ndarray  # [A*H, A*W, 2]


@dataclass
class TrainArrays:
    lr: np.ndarray  # [N, A*h, A*w] float32
    hr: np.ndarray  # [N, A*H, A*W] float32

    def __len__(self):
        return self.lr.shape[0]


def draw_augment(gen: torch.Generator, b: int) -> torch.Tensor:
    """Flags [3, b] bool: W-flip, H-flip, transpose, each with p = 0.5."""
    return torch.rand((3, b), generator=gen, device=gen.device) < 0.5


def apply_augment(lr: torch.Tensor, hr: torch.Tensor, flags: torch.Tensor):
    """Apply the per-item flips and transpose to lr [B, A*h, A*w] and hr
    (square mosaics), in the order W-flip, H-flip, transpose."""

    def one(x):
        fw, fh, ft = (f[:, None, None] for f in flags)
        x = torch.where(fw, x.flip(2), x)
        x = torch.where(fh, x.flip(1), x)
        return torch.where(ft, x.transpose(1, 2), x)

    return one(lr), one(hr)


def augment_batch(gen: torch.Generator, lr: torch.Tensor, hr: torch.Tensor):
    return apply_augment(lr, hr, draw_augment(gen, lr.shape[0]))


def tile_indices(perm: torch.Tensor, batch: int, steps: int) -> torch.Tensor:
    """[steps, batch] indices: the permutation repeated as often as needed."""
    need = steps * batch
    reps = -(-need // perm.numel())
    return perm.repeat(reps)[:need].reshape(steps, batch)


def batch_indices(gen: torch.Generator, n: int, batch: int, steps: int) -> torch.Tensor:
    """An epoch's shuffled batch indices [steps, batch] (int64)."""
    return tile_indices(torch.randperm(n, generator=gen, device=gen.device), batch, steps)

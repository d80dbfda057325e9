"""Data: loaders, records and in-step augmentation of the port (jax-free
twins of ``lfsr_tpu.data.datasets``).

- ``TestScene`` and ``TrainArrays``: the same fields as the JAX records.
- ``list_train_files``, ``load_train_set``, ``load_test_scenes``: the JAX
  loaders' semantics (the task directory ``<root>/<task_tag>/``, the
  ``data_name="ALL"`` listing of its datasets in sorted order, files in
  sorted order, the chroma fallback, ``FileNotFoundError`` on an empty
  training tree, ``tag`` for the RE task) on ``.npz`` files, read with
  numpy alone. The format, one file per item:

      <root>/<task_tag>/<dataset>/<stem>.npz
          Lr_SAI_y     float32 [A*h, A*w]     LR SAI mosaic (Y)
          Hr_SAI_y     float32 [A*H, A*W]     HR SAI mosaic (Y)
          Sr_SAI_cbcr  float32 [A*H, A*W, 2]  upsampled chroma (test sets;
                                              zeros when absent)

  All row-major: exactly the arrays the JAX loaders return after their
  transposes of the MATLAB-written ``.h5`` files. ``scripts/export_npz.py``
  (run where the JAX package and h5py are) writes one ``.npz`` for each
  ``.h5`` of a tree, with the same stem and relative path.
- ``augment_batch``: per item, an independent 50% W-flip, H-flip and
  transpose of the whole SAI mosaic (the LF U<->V + H<->W transpose), the
  same for LR and HR; split into ``draw_augment`` (flags from a
  ``torch.Generator`` on its device) and ``apply_augment``.
- ``batch_indices``: an epoch of shuffled batch indices from
  ``torch.randperm``; ``tile_indices`` is its deterministic half.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

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


def _dataset_dir(root: str, ang: int, scale: int, tag: str | None = None) -> Path:
    """Task directory: 'SR_AxA_sx' by default, or an explicit tag such as
    'RE_2x2_5x5'."""
    return Path(root) / (tag or f"SR_{ang}x{ang}_{scale}x")


def _datasets(base: Path, data_name: str) -> list[str]:
    return sorted(os.listdir(base)) if data_name == "ALL" else [data_name]


def _items(d: Path) -> list[Path]:
    """The ``.npz`` files of a dataset directory, in the order the JAX
    loaders list the ``.h5`` files they were exported from (sorted by the
    ``.h5`` name)."""
    stems = [f[:-4] for f in os.listdir(d) if f.endswith(".npz")]
    return [d / f"{s}.npz" for s in sorted(stems, key=lambda s: s + ".h5")]


def _read(f: Path, *keys: str) -> dict[str, np.ndarray]:
    with np.load(f) as z:
        return {k: np.asarray(z[k], dtype=np.float32) for k in keys if k in z.files}


def list_train_files(root: str, ang: int, scale: int, data_name: str = "ALL",
                     tag: str | None = None) -> list[Path]:
    base = _dataset_dir(root, ang, scale, tag)
    files = []
    for ds in _datasets(base, data_name):
        d = base / ds
        if d.is_dir():
            files += _items(d)
    return files


def load_train_set(root: str, ang: int, scale: int, data_name: str = "ALL",
                   tag: str | None = None) -> TrainArrays:
    """Every training item's LR/HR mosaics, stacked in listing order."""
    lrs, hrs = [], []
    for f in list_train_files(root, ang, scale, data_name, tag):
        item = _read(f, "Lr_SAI_y", "Hr_SAI_y")
        lrs.append(item["Lr_SAI_y"])
        hrs.append(item["Hr_SAI_y"])
    if not lrs:
        raise FileNotFoundError(f"no training .npz under {_dataset_dir(root, ang, scale)}")
    return TrainArrays(lr=np.stack(lrs), hr=np.stack(hrs))


def load_test_scenes(root: str, ang: int, scale: int, data_name: str = "ALL",
                     tag: str | None = None) -> dict[str, list[TestScene]]:
    """Per-dataset lists of whole test scenes (datasets without a scene are
    left out); the chroma is zeros where a file has none."""
    base = _dataset_dir(root, ang, scale, tag)
    out: dict[str, list[TestScene]] = {}
    for ds in _datasets(base, data_name):
        d = base / ds
        if not d.is_dir():
            continue
        scenes = []
        for f in _items(d):
            item = _read(f, "Lr_SAI_y", "Hr_SAI_y", "Sr_SAI_cbcr")
            hr = item["Hr_SAI_y"]
            cbcr = item.get("Sr_SAI_cbcr")
            if cbcr is None:
                cbcr = np.zeros((*hr.shape, 2), dtype=np.float32)
            scenes.append(TestScene(name=f.stem, dataset=ds, lr_y=item["Lr_SAI_y"], hr_y=hr,
                                    sr_cbcr=cbcr))
        if scenes:
            out[ds] = scenes
    return out


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

#!/usr/bin/env python
"""Export the JAX package's data files and checkpoints to ``.npz``, the
format the PyTorch port (``lfsr_tpu_torch``) reads with numpy alone.

Runs where the JAX package runs (jax, flax, optax, orbax, h5py) and reads
only through its own functions:

    python scripts/export_npz.py train SRC DST [flags]
        every training .h5 under SRC/<task_tag>/ (``list_train_files``)
        -> DST/<same path>.npz: Lr_SAI_y and Hr_SAI_y as
        ``load_train_set`` reads them, one item at a time
    python scripts/export_npz.py test SRC DST [flags]
        every test scene under SRC/<task_tag>/ (``load_test_scenes``) ->
        DST/<task_tag>/<dataset>/<scene>.npz (Lr_SAI_y, Hr_SAI_y,
        Sr_SAI_cbcr)
    python scripts/export_npz.py checkpoint CKPT OUT.npz [flags]
        the orbax checkpoint CKPT (``restore_checkpoint`` on the template
        of ``Trainer(cfg).init_state``) -> one .npz: the flax param tree
        under ``params/<scope>/.../<leaf>``, optax's first and second
        moments under ``mu/...`` and ``nu/...`` with the same paths, and
        ``count``, ``notfinite_count``, ``last_finite``,
        ``total_notfinite``, ``step`` and ``epoch``

[flags] are the JAX entry points' (``lfsr_tpu.cli``): --angRes,
--scale_factor, --task, --angRes_out and --data_name pick the tree; the
model flags (--model_name, --model_kwargs, ...) the checkpoint's model.
The arrays are float32 and row-major, as the JAX loaders return them after
their transposes of the MATLAB-written files.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np


def export_train(src: str, dst: str, cfg) -> int:
    """One item at a time: each file is linked alone into a scratch tree
    under DST and read there by ``load_train_set``, so a training set of
    any size needs the memory of one item."""
    from lfsr_tpu.data.datasets import list_train_files, load_train_set

    tag = cfg.task_tag()
    files = list_train_files(src, cfg.angRes, cfg.scale_factor, cfg.data_name, tag=tag)
    Path(dst).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix=".export_", dir=dst) as scratch:
        for f in files:
            rel = Path(f).relative_to(src)  # <task_tag>/<dataset>/<stem>.h5
            link = Path(scratch) / rel
            link.parent.mkdir(parents=True, exist_ok=True)
            link.symlink_to(Path(f).resolve())
            item = load_train_set(scratch, cfg.angRes, cfg.scale_factor, rel.parent.name, tag=tag)
            link.unlink()
            out = Path(dst) / rel.with_suffix(".npz")
            out.parent.mkdir(parents=True, exist_ok=True)
            np.savez(out, Lr_SAI_y=item.lr[0], Hr_SAI_y=item.hr[0])
    return len(files)


def export_test(src: str, dst: str, cfg) -> int:
    from lfsr_tpu.data.datasets import load_test_scenes

    n = 0
    sets = load_test_scenes(src, cfg.angRes, cfg.scale_factor, cfg.data_name, tag=cfg.task_tag())
    for ds, scenes in sets.items():
        d = Path(dst) / cfg.task_tag() / ds
        d.mkdir(parents=True, exist_ok=True)
        for sc in scenes:
            np.savez(d / f"{sc.name}.npz", Lr_SAI_y=sc.lr_y, Hr_SAI_y=sc.hr_y,
                     Sr_SAI_cbcr=sc.sr_cbcr)
            n += 1
    return n


def _flat(tree, prefix: str) -> dict[str, np.ndarray]:
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(p.key) for p in path]
        out["/".join([prefix, *keys])] = np.asarray(leaf, dtype=np.float32)
    return out


def export_checkpoint(ckpt: str, out: str, cfg) -> int:
    import jax
    import optax

    from lfsr_tpu.train.trainer import Trainer, restore_checkpoint

    tr = Trainer(cfg, steps_per_epoch=1)
    template = tr.init_state(
        jax.random.key(0), np.zeros((1, cfg.angRes * 32, cfg.angRes * 32, 1), np.float32))
    state, epoch = restore_checkpoint(ckpt, template)
    st = state.opt_state  # apply_if_finite(chain(clip, adamw)) state
    _, (adam, *_) = st.inner_state
    assert isinstance(adam, optax.ScaleByAdamState), type(adam)
    arrays = {**_flat(state.params, "params"), **_flat(adam.mu, "mu"), **_flat(adam.nu, "nu"),
              "count": np.asarray(adam.count, np.int32),
              "notfinite_count": np.asarray(st.notfinite_count, np.int32),
              "last_finite": np.asarray(st.last_finite, bool),
              "total_notfinite": np.asarray(st.total_notfinite, np.int32),
              "step": np.asarray(state.step, np.int32), "epoch": np.asarray(epoch, np.int32)}
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    return len(arrays)


KINDS = {"train": export_train, "test": export_test, "checkpoint": export_checkpoint}


def main(argv=None) -> int:
    from lfsr_tpu.cli import build_parser, config_from_args

    p = build_parser()
    p.description = __doc__.split("\n")[0]
    p.add_argument("kind", choices=tuple(KINDS))
    p.add_argument("src", help="data root (train/test) or orbax checkpoint directory")
    p.add_argument("dst", help="output root (train/test) or .npz path (checkpoint)")
    args = p.parse_args(argv)
    n = KINDS[args.kind](args.src, args.dst, config_from_args(args))
    print(f"export_npz {args.kind}: {n} {'arrays' if args.kind == 'checkpoint' else 'files'} "
          f"-> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository root
    sys.exit(main())

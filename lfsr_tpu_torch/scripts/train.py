"""Training entry point (the port of the JAX package's ``train.py``).

Loads the ``.npz`` training set (and the test sets when there are any),
initialises from ``bridge.init_params`` seeded by ``--seed`` or resumes from
the newest ``checkpoints/epoch_*``, then per epoch runs ``Trainer.run_epoch``,
logs the JAX line, saves the full train state, and validates with
``evaluate_sets`` every ``eval_every`` epochs and at the last one, writing
``results/evaluation_epoch%03d.csv``.

    python -m lfsr_tpu_torch.scripts.train --path_for_train DIR --epoch 51 ...
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.cli import build_parser, config_from_args
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.data.datasets import load_test_scenes, load_train_set
from lfsr_tpu_torch.train.evaluate import evaluate_sets
from lfsr_tpu_torch.train.trainer import (
    Trainer, latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from lfsr_tpu_torch.utils import Logger, MetricSheet, create_dirs


def main(cfg: Config, device="cuda") -> Trainer:
    log_dir, ckpt_dir, results_dir = create_dirs(cfg)
    log = Logger(log_dir, cfg.model_name)
    log(f"device: {torch.device(device)}")
    log(f"config: {cfg}")

    data = load_train_set(cfg.path_for_train, cfg.angRes, cfg.scale_factor, cfg.data_name,
                          tag=cfg.task_tag())
    log(f"train items: {len(data)}  LR {data.lr.shape}  HR {data.hr.shape}")
    try:
        test_sets = load_test_scenes(cfg.path_for_test, cfg.angRes, cfg.scale_factor,
                                     cfg.data_name, tag=cfg.task_tag())
    except FileNotFoundError:
        test_sets = {}

    steps_per_epoch = max(1, len(data) // cfg.batch_size)
    sd = init_params(cfg, torch.Generator().manual_seed(cfg.seed))
    tr = Trainer(cfg, steps_per_epoch, sd, device=device)

    start_epoch = 0
    resume = latest_checkpoint(ckpt_dir)
    if resume is not None:
        last = restore_checkpoint(resume, tr)
        start_epoch = last + 1
        log(f"resumed from {resume} (epoch {last})")

    for epoch in range(start_epoch, cfg.epochs):
        metrics = tr.run_epoch(data, epoch)
        log(
            f"epoch {epoch:03d}: loss {metrics['loss']:.5f} "
            f"psnr {metrics['psnr']:.3f} ssim {metrics['ssim']:.4f} "
            f"mask {metrics['mask_ratio']:.2f}"
        )
        save_checkpoint(ckpt_dir, tr, epoch)

        # validate every `eval_every` epochs (first at epoch eval_every-1)
        # and at the end
        if test_sets and ((epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1):
            tr.model.eval()
            results = evaluate_sets(tr.model, test_sets, cfg, log)
            tr.model.train()
            sheet = MetricSheet()
            for name, r in results.items():
                sheet.add_set(name, r["scenes"])
            sheet.save(results_dir / f"evaluation_epoch{epoch:03d}")
    log("training complete")
    return tr


if __name__ == "__main__":
    main(config_from_args(build_parser().parse_args()))

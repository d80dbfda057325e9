"""Evaluation entry point (the port of the JAX package's ``test.py``).

Loads the newest checkpoint (or ``--ckpt``: a ``.pt`` of the port or a
JAX checkpoint exported to ``.npz``), runs ``evaluate_scene`` on every
scene of every test set, logs per-scene and per-set PSNR/SSIM, writes
``results/evaluation.csv`` and, unless ``--no_save_views``, each scene's
25 RGB views as ``results/<set>/<scene>/View_i_j.bmp``.

    python -m lfsr_tpu_torch.scripts.test --path_for_test DIR [--ckpt PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.cli import build_parser, config_from_args
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.data.datasets import load_test_scenes
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.ops.color import views_to_rgb_uint8
from lfsr_tpu_torch.tools.submission import save_scene_views
from lfsr_tpu_torch.train.evaluate import evaluate_scene
from lfsr_tpu_torch.train.trainer import latest_checkpoint, load_params
from lfsr_tpu_torch.utils import Logger, MetricSheet, create_dirs


def load_model(cfg: Config, ckpt_dir, ckpt_path, log, device):
    """``cfg``'s model on ``device`` with the parameters of ``ckpt_path``,
    else of the newest checkpoint in ``ckpt_dir``, else the init seeded by
    0 (with a warning). Returns (model, the checkpoint's path or None)."""
    model = get_model(cfg, device=device)
    path = ckpt_path or latest_checkpoint(ckpt_dir)
    if path is not None:
        sd, epoch = load_params(path, cfg)
        model.load_state_dict(sd)
        log(f"loaded checkpoint {path} (epoch {epoch})")
    else:
        model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return model, path


def main(cfg: Config, ckpt_path=None, save_views: bool = True, device="cuda"):
    log_dir, ckpt_dir, results_dir = create_dirs(cfg)
    log = Logger(log_dir, cfg.model_name + "_test")

    test_sets = load_test_scenes(cfg.path_for_test, cfg.angRes, cfg.scale_factor,
                                 cfg.data_name, tag=cfg.task_tag())
    model, path = load_model(cfg, ckpt_dir, ckpt_path, log, device)
    if path is None:
        log("WARNING: no checkpoint found — evaluating random init")

    sheet = MetricSheet()
    for name, scenes in test_sets.items():
        per_scene = []
        for sc in scenes:
            p, s, sr_views = evaluate_scene(model, sc, cfg)
            per_scene.append((sc.name, p, s))
            log(f"{name}/{sc.name}: PSNR {p:.3f} SSIM {s:.4f}")
            if save_views:
                rgb = views_to_rgb_uint8(sr_views.cpu().numpy(), sc.sr_cbcr, cfg.angRes)
                save_scene_views(results_dir / name / sc.name, rgb)
        sheet.add_set(name, per_scene)
        log(f"{name} average: PSNR {np.mean([x[1] for x in per_scene]):.3f} "
            f"SSIM {np.mean([x[2] for x in per_scene]):.4f}")
    sheet.save(results_dir / "evaluation")
    log("evaluation complete")


if __name__ == "__main__":
    p = build_parser()
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--no_save_views", action="store_true")
    args = p.parse_args()
    main(config_from_args(args), args.ckpt, not args.no_save_views)

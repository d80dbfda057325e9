"""Submission inference (the port of the JAX package's ``inference.py``).

The efficiency gate runs first and aborts unless it passes (or
``--skip_gate``); then the newest checkpoint (or ``--ckpt``, ``.pt`` or an
exported ``.npz``) is loaded and ``inference.infer_submission`` writes the
CodaBench ``<out>/<subset>/<scene>/View_i_j.bmp`` tree of every test
subset, packs ``<out>.zip`` (unless ``--no_zip``) and validates it.

    python -m lfsr_tpu_torch.scripts.inference --path_for_test DIR --out submission
"""

from __future__ import annotations

from pathlib import Path

from lfsr_tpu_torch.cli import build_parser, config_from_args
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.data.datasets import load_test_scenes
from lfsr_tpu_torch.inference import infer_submission
from lfsr_tpu_torch.scripts.test import load_model
from lfsr_tpu_torch.tools.efficiency import check_efficiency, format_report
from lfsr_tpu_torch.utils import Logger, create_dirs


def main(cfg: Config, ckpt_path=None, out_root="submission", make_zip=True, skip_gate=False,
         device="cuda"):
    """Returns the zip's path (the tree's without ``make_zip``), or None
    when the gate refuses the model."""
    log_dir, ckpt_dir, _ = create_dirs(cfg)
    log = Logger(log_dir, cfg.model_name + "_infer")

    if not skip_gate:
        report = check_efficiency(cfg, device=device)
        log(format_report(report))
        if not report["verdict"]:
            log("efficiency gate FAILED — aborting (use --skip_gate to override)")
            return None

    scenes = load_test_scenes(cfg.path_for_test, cfg.angRes, cfg.scale_factor, cfg.data_name,
                              tag=cfg.task_tag())
    model, path = load_model(cfg, ckpt_dir, ckpt_path, log, device)
    if path is None:
        log("WARNING: no checkpoint — running random init")
    out = Path(out_root)
    infer_submission(model, scenes, cfg, out, make_zip=make_zip, log=log)
    return out.with_suffix(".zip") if make_zip else out


if __name__ == "__main__":
    p = build_parser()
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--out", type=str, default="submission")
    p.add_argument("--no_zip", action="store_true")
    p.add_argument("--skip_gate", action="store_true")
    args = p.parse_args()
    main(config_from_args(args), args.ckpt, args.out, not args.no_zip, args.skip_gate)

"""Logger, per-scene metric sheet, and the log/ directory schema.

The port's own copy of ``lfsr_tpu/utils/logging.py``, so the two packages
write the same files:
- directory layout ``log/<task_tag>/<data>/<model>/{checkpoints,results}``;
- log lines ``<time> - <logger> - INFO - <message>`` in ``<name>.txt``,
  each message also printed;
- a per-scene PSNR/SSIM sheet with per-dataset averages: a CSV with the
  columns Datasets, Scenes, PSNR, SSIM (6 decimals), plus ``.xls`` when
  ``xlwt`` happens to be installed.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

from lfsr_tpu_torch.config import Config

COLUMNS = ["Datasets", "Scenes", "PSNR", "SSIM"]


def create_dirs(cfg: Config):
    base = Path(cfg.path_log) / cfg.task_tag() / cfg.data_name / cfg.model_name
    ckpt = base / "checkpoints"
    results = base / "results"
    for d in (base, ckpt, results):
        d.mkdir(parents=True, exist_ok=True)
    return base, ckpt, results


class Logger:
    def __init__(self, log_dir: Path, name: str):
        self._logger = logging.getLogger(f"lfsr_tpu_torch.{name}")
        self._logger.setLevel(logging.INFO)
        for h in self._logger.handlers:
            h.close()
        self._logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        fh = logging.FileHandler(Path(log_dir) / f"{name}.txt")
        fh.setFormatter(fmt)
        self._logger.addHandler(fh)
        self._logger.propagate = False

    def log(self, msg: str):
        self._logger.info(msg)
        print(msg, flush=True)

    __call__ = log


class MetricSheet:
    """Per-scene PSNR/SSIM accumulator -> CSV (and .xls if available)."""

    def __init__(self):
        self.rows: list[tuple[str, str, float, float]] = []

    def add(self, dataset: str, scene: str, psnr: float, ssim: float):
        self.rows.append((dataset, scene, psnr, ssim))

    def add_set(self, dataset: str, per_scene):
        for name, p, s in per_scene:
            self.add(dataset, name, p, s)
        self.add(
            dataset,
            "average",
            float(np.mean([x[1] for x in per_scene])),
            float(np.mean([x[2] for x in per_scene])),
        )

    def save(self, path: str | Path):
        path = Path(path)
        with open(path.with_suffix(".csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(COLUMNS)
            for ds, sc, p, s in self.rows:
                w.writerow([ds, sc, f"{p:.6f}", f"{s:.6f}"])
        try:  # optional legacy .xls for drop-in compatibility
            import xlwt
        except ImportError:
            return
        wb = xlwt.Workbook()
        sh = wb.add_sheet("sheet1", cell_overwrite_ok=True)
        for j, col in enumerate(COLUMNS):
            sh.write(0, j, col)
        for i, (ds, sc, p, s) in enumerate(self.rows, start=1):
            sh.write(i, 0, ds)
            sh.write(i, 1, sc)
            sh.write(i, 2, f"{p:.6f}")
            sh.write(i, 3, f"{s:.6f}")
        wb.save(str(path.with_suffix(".xls")))

"""Submission packaging and validation for the NTIRE Track-2 format.

The port's own copy of the parts of ``lfsr_tpu/tools/submission.py`` that
``inference.infer_submission`` uses; tests hold its reports equal to the
JAX package's on the same trees.

Contract: a zip or directory with ``Real/`` and ``Synth/`` roots, 16 scenes
each, every scene holding 25 ``View_i_j.bmp`` (i, j in 0..4), 24-bit
uncompressed BMP; Real views are 624x432, Synth 500x500 (width x height).
The validator checks structure, scene counts, view names, byte-level BMP
headers, dimensions per subset, and pixel-content heuristics on a sample
(dark / saturated / low-variance views).
"""

from __future__ import annotations

import zipfile
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from lfsr_tpu_torch.tools import bmp

EXPECTED_SCENES = {"Real": 16, "Synth": 16}
EXPECTED_DIMS = {"Real": (624, 432), "Synth": (500, 500)}  # (W, H)
VIEW_NAMES = [f"View_{i}_{j}.bmp" for i in range(5) for j in range(5)]
MIN_PIXEL_MEAN, MAX_PIXEL_MEAN, MIN_PIXEL_STD = 20.0, 235.0, 5.0


def save_scene_views(out_dir: str | Path, sr_rgb_views: np.ndarray):
    """Write 25 View_i_j.bmp for one scene; input [U, V, h, w, 3] uint8."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    U, V = sr_rgb_views.shape[:2]
    for i in range(U):
        for j in range(V):
            bmp.write_bmp(out / f"View_{i}_{j}.bmp", sr_rgb_views[i, j])


def pack_submission(root: str | Path, zip_path: str | Path):
    """Zip a {Real/, Synth/} tree preserving the required layout."""
    root = Path(root)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for sub in ("Real", "Synth"):
            base = root / sub
            if not base.is_dir():
                continue
            for f in sorted(base.rglob("*.bmp")):
                zf.write(f, f.relative_to(root))
    return Path(zip_path)


@dataclass
class ValidationReport:
    errors: list[str] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)
    checks: int = 0

    @property
    def ok(self) -> bool:
        return not self.errors

    def err(self, msg):
        self.errors.append(msg)

    def warn(self, msg):
        self.warnings.append(msg)


class _Files:
    """Uniform accessor over a zip or a directory."""

    def __init__(self, path: str | Path):
        p = Path(path)
        if p.is_dir():
            self._zip = None
            self._root = p
            self.names = [str(f.relative_to(p)).replace("\\", "/") for f in p.rglob("*")
                          if f.is_file()]
        else:
            self._zip = zipfile.ZipFile(p)
            self._root = None
            self.names = [n for n in self._zip.namelist() if not n.endswith("/")]

    def read(self, name: str) -> bytes:
        if self._zip is not None:
            return self._zip.read(name)
        return (self._root / name).read_bytes()


def validate_submission(path: str | Path, sample_pixels: int = 3) -> ValidationReport:
    rep = ValidationReport()
    try:
        files = _Files(path)
    except (OSError, zipfile.BadZipFile) as e:
        rep.err(f"cannot open submission: {e}")
        return rep

    by_subset: dict[str, dict[str, list[str]]] = {"Real": {}, "Synth": {}}
    for name in files.names:
        parts = name.split("/")
        if len(parts) >= 3 and parts[0] in by_subset and parts[-1].endswith(".bmp"):
            by_subset[parts[0]].setdefault(parts[1], []).append(name)

    rng = np.random.default_rng(0)
    for subset, expected_n in EXPECTED_SCENES.items():
        scenes = by_subset[subset]
        rep.checks += 1
        if len(scenes) != expected_n:
            rep.err(f"{subset}: {len(scenes)} scenes, expected {expected_n}")
        for scene, names in sorted(scenes.items()):
            base = {n.split("/")[-1] for n in names}
            missing = set(VIEW_NAMES) - base
            extra = base - set(VIEW_NAMES)
            rep.checks += 1
            if missing:
                rep.err(f"{subset}/{scene}: missing views {sorted(missing)[:5]}...")
            if extra:
                rep.warn(f"{subset}/{scene}: unexpected files {sorted(extra)[:5]}")

            # header checks on every view; pixel checks on a sample
            sampled = set(
                rng.choice(len(names), size=min(sample_pixels, len(names)), replace=False)
            )
            for k, n in enumerate(sorted(names)):
                data = files.read(n)
                info = bmp.parse_header(data)
                rep.checks += 1
                if info is None or info["magic"] != b"BM":
                    rep.err(f"{n}: not a valid BMP")
                    continue
                if info["bits_per_pixel"] != 24:
                    rep.err(f"{n}: {info['bits_per_pixel']} bpp, expected 24")
                if info["compression"] != 0:
                    rep.err(f"{n}: compressed BMP not allowed")
                w_h = (info["width"], abs(info["height"]))
                if w_h != EXPECTED_DIMS[subset]:
                    rep.err(f"{n}: dims {w_h}, expected {EXPECTED_DIMS[subset]}")
                if k in sampled and not rep.errors:
                    img = bmp.decode_bmp(data)
                    m, s = float(img.mean()), float(img.std())
                    if m < MIN_PIXEL_MEAN:
                        rep.warn(f"{n}: very dark (mean {m:.1f})")
                    if m > MAX_PIXEL_MEAN:
                        rep.warn(f"{n}: near-saturated (mean {m:.1f})")
                    if s < MIN_PIXEL_STD:
                        rep.warn(f"{n}: suspiciously low variance (std {s:.1f})")
    return rep

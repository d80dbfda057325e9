"""Submission inference (port of inference.py's scene loop and packaging).

``infer_submission`` super-resolves the NTIRE ``Real``/``Synth`` test
scenes with a loaded model, recomposes RGB from each scene's upsampled
chroma, writes the CodaBench ``<subset>/<scene>/View_i_j.bmp`` tree, then
packs it into a zip and validates it with the port's
``tools.submission`` (its own copy of the JAX package's packager and
validator). Whole-scene mode (the flagship's default)
batches same-geometry scenes as ``evaluate_sets`` does; tiled mode runs
one scene at a time (both through ``sr_views``).

The caller passes a loaded model; ``scripts/inference.py`` is the command
line around it (the efficiency gate, the checkpoint, the test sets).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.ops.color import views_to_rgb_uint8
from lfsr_tpu_torch.tools.submission import pack_submission, save_scene_views, validate_submission
from lfsr_tpu_torch.train.evaluate import sr_views


def infer_submission(model, scenes_by_subset: dict, cfg: Config, out_root, make_zip: bool = True,
                     log=print):
    """Write ``out_root/<subset>/<scene>/View_i_j.bmp`` for every scene of
    ``scenes_by_subset`` ({"Real": [TestScene], "Synth": [...]}); with
    ``make_zip`` pack ``out_root.zip`` and validate it, else validate the
    directory. Returns the ``ValidationReport``."""
    out = Path(out_root)
    for subset, scenes in scenes_by_subset.items():
        for sc, views in sr_views(model, scenes, cfg):
            rgb = views_to_rgb_uint8(views.cpu().numpy(), np.asarray(sc.sr_cbcr), cfg.angRes)
            save_scene_views(out / subset / sc.name, rgb)
            log(f"wrote {subset}/{sc.name} ({rgb.shape[3]}x{rgb.shape[2]})")
    target = pack_submission(out, out.with_suffix(".zip")) if make_zip else out
    rep = validate_submission(target)
    log(f"submission {target}: {'VALID' if rep.ok else 'INVALID'} "
        f"({rep.checks} checks, {len(rep.errors)} errors, {len(rep.warnings)} warnings)")
    for e in rep.errors[:10]:
        log(f"  ERROR: {e}")
    return rep

"""Tiled evaluation (port of lfsr_tpu/train/evaluate.py, tiled mode).

A scene's SAI mosaic is split into overlapping SAI patches (``lf_divide``,
LR patch 32 / stride 16 by default), the patch grid is zero-padded to a
multiple of ``minibatch``, each fixed-shape chunk of ``minibatch`` patches
goes through the model (a Python loop in place of the JAX ``lax.map``),
the SR patches are stitched by center crop (``lf_integrate``) and PSNR/SSIM
are scored per view on Y.

Whole-scene (un-tiled) evaluation, EPSW Gaussian stitching, the angular
(RE) task and multi-device sharding are not ported yet: asking for them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.registry import whole_scene_default
from lfsr_tpu_torch.ops.metrics import lf_metrics
from lfsr_tpu_torch.ops.tiling import lf_divide, lf_integrate

WHOLE_SCENE_ROADMAP = (
    "ROADMAP.md queue 1: whole-scene eval (with the K7 kernel, queue 2)"
)


def _integrate(sr, ang_out, patch, scale, stride, h0, w0, integrate="crop", sigma=None):
    if integrate != "crop":
        raise NotImplementedError("EPSW Gaussian stitching is not ported yet (ROADMAP.md)")
    return lf_integrate(sr, ang_out, patch * scale, stride * scale, h0 * scale, w0 * scale)


def sr_scene(model, lr_sai: torch.Tensor, *, ang: int, scale: int, patch: int, stride: int,
             minibatch: int, h0: int, w0: int, ang_out: int | None = None,
             integrate: str = "crop", integrate_sigma: float | None = None,
             whole: bool = False) -> torch.Tensor:
    """Super-resolve one scene, tiled. ``lr_sai`` [A*h0, A*w0] float32 on
    the model's device; returns SR views [A_out, A_out, h0*s, w0*s]."""
    if whole:
        raise NotImplementedError(f"whole-scene evaluation is not ported: {WHOLE_SCENE_ROADMAP}")
    ang_out = ang_out or ang
    patches = lf_divide(lr_sai, ang, patch, stride)  # [N, A*p, A*p]
    n = patches.shape[0]
    n_pad = -(-n // minibatch) * minibatch
    patches = torch.nn.functional.pad(patches, (0, 0, 0, 0, 0, n_pad - n))
    outs = []
    with torch.inference_mode():
        for i in range(0, n_pad, minibatch):
            outs.append(model(patches[i : i + minibatch, ..., None])[..., 0])
    sr = torch.cat(outs)[:n]
    return _integrate(sr, ang_out, patch, scale, stride, h0, w0, integrate, integrate_sigma)


def _check_ported(cfg: Config) -> None:
    if whole_scene_default(cfg):
        raise NotImplementedError(
            f"whole-scene evaluation (Config.whole_scene_for_test, or the model's "
            f"default when it is None) is not ported: {WHOLE_SCENE_ROADMAP}; pass "
            f"Config(whole_scene_for_test=False) for the tiled protocol"
        )
    if cfg.task != "SR":
        raise NotImplementedError(f"task {cfg.task!r}: only SR evaluation is ported")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def evaluate_scene(model, scene, cfg: Config):
    """SR + metrics for one TestScene. Returns (psnr, ssim, sr_views)."""
    _check_ported(cfg)
    ang, s = cfg.angRes, cfg.scale_factor
    h0 = scene.lr_y.shape[0] // ang
    w0 = scene.lr_y.shape[1] // ang
    lr = torch.as_tensor(np.asarray(scene.lr_y, np.float32), device=_device_of(model))
    sr_views = sr_scene(
        model, lr, ang=ang, scale=s, patch=cfg.patch_size_for_test,
        stride=cfg.stride_for_test, minibatch=cfg.minibatch_for_test, h0=h0, w0=w0,
        ang_out=cfg.angRes_out, integrate="gaussian" if cfg.epsw_for_test else "crop",
        integrate_sigma=cfg.epsw_sigma,
    )
    p, ssim_v = _score_views(scene, sr_views, ang, cfg.angRes_out, s)
    return p, ssim_v, sr_views


def _score_views(scene, sr_views, ang, ang_out, s):
    h0 = scene.lr_y.shape[0] // ang
    w0 = scene.lr_y.shape[1] // ang
    sr_sai = sr_views.movedim(2, 1).reshape(ang_out * h0 * s, ang_out * w0 * s)
    hr = torch.as_tensor(np.asarray(scene.hr_y[: ang_out * h0 * s, : ang_out * w0 * s],
                                    np.float32), device=sr_views.device)
    p, ssim_v = lf_metrics(hr, sr_sai, ang)
    return float(p), float(ssim_v)


def evaluate_sets(model, scenes_by_set: dict, cfg: Config, log=print,
                  keep_views: bool = False) -> dict:
    """Per-dataset averages over tiled scenes. Returns
    ``{set: {"psnr", "ssim", "scenes": [(name, psnr, ssim), ...]}}``, plus
    ``"views": {scene name: SR views}`` with ``keep_views``."""
    _check_ported(cfg)
    results = {}
    for name, scenes in scenes_by_set.items():
        per_scene, views = [], {}
        for sc in scenes:
            p, s, v = evaluate_scene(model, sc, cfg)
            per_scene.append((sc.name, p, s))
            if keep_views:
                views[sc.name] = v
            log(f"  {name}/{sc.name}: PSNR {p:.3f} SSIM {s:.4f}")
        avg_p = float(np.mean([x[1] for x in per_scene]))
        avg_s = float(np.mean([x[2] for x in per_scene]))
        results[name] = {"psnr": avg_p, "ssim": avg_s, "scenes": per_scene}
        if keep_views:
            results[name]["views"] = views
        log(f"  {name} average: PSNR {avg_p:.3f} SSIM {avg_s:.4f}")
    return results

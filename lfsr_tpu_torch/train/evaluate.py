"""Evaluation (port of lfsr_tpu/train/evaluate.py): whole-scene and tiled.

Whole-scene mode, the flagship's default (``Config.whole_scene_for_test``
None defers to the registry): each view of a scene's SAI mosaic is
mirror-extended by ``whole_scene_pad`` LR pixels, rounded up to a multiple
of 8 (:func:`_whole_pad_batch`), the padded mosaic goes through the model
un-tiled, and the pad is cropped off the SR views. ``evaluate_sets`` groups
same-geometry scenes and runs ``whole_scene_minibatch`` of them per model
call (:func:`sr_scenes_whole`).

Tiled mode: a scene's mosaic is split into overlapping SAI patches
(``lf_divide``, LR patch 32 / stride 16 by default), the patch grid is
zero-padded to a multiple of ``minibatch``, each chunk of ``minibatch``
patches goes through the model (a Python loop in place of the JAX
``lax.map``), and the SR patches are stitched by center crop
(``lf_integrate``).

Both score PSNR/SSIM per view on Y. EPSW Gaussian stitching and the
angular (RE) task are not ported yet and raise ``NotImplementedError``;
neither is multi-device sharding (``sr_scenes_whole_sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.registry import whole_scene_default
from lfsr_tpu_torch.ops.layout import sai_to_views
from lfsr_tpu_torch.ops.metrics import lf_metrics
from lfsr_tpu_torch.ops.tiling import lf_divide, lf_integrate, symmetric_index


def _integrate(sr, ang_out, patch, scale, stride, h0, w0, integrate="crop", sigma=None):
    if integrate != "crop":
        raise NotImplementedError("EPSW Gaussian stitching is not ported yet (ROADMAP.md)")
    return lf_integrate(sr, ang_out, patch * scale, stride * scale, h0 * scale, w0 * scale)


def _whole_pad_batch(x: torch.Tensor, ang: int, whole_pad: int):
    """Mirror-extend each view of SAI mosaics ``x`` [N, A*h0, A*w0] by
    ``p = min(whole_pad, h0 - 8, w0 - 8)`` LR pixels (numpy 'symmetric'),
    with the bottom/right pads rounding each padded view up to a multiple
    of 8. Returns ``(padded, p)``; ``p == 0`` returns x unchanged."""
    n, H, W = x.shape
    h0, w0 = H // ang, W // ang
    p = min(whole_pad, max(h0 - 8, 0), max(w0 - 8, 0))
    if p == 0:
        return x, 0
    pb = p + (-(h0 + 2 * p) % 8)
    pr = p + (-(w0 + 2 * p) % 8)
    hi = torch.from_numpy(symmetric_index(h0, p, pb)).to(x.device)
    wi = torch.from_numpy(symmetric_index(w0, p, pr)).to(x.device)
    v = x.reshape(n, ang, h0, ang, w0).index_select(2, hi).index_select(4, wi)
    return v.reshape(n, ang * (h0 + p + pb), ang * (w0 + p + pr)), p


def _whole_run(model, sais: torch.Tensor, ang: int, ang_out: int, scale: int,
               whole_pad: int) -> torch.Tensor:
    """One model call on a batch of whole scenes [N, A*h0, A*w0]: pad,
    SR, views [N, A_out, A_out, h0*s, w0*s] with the pad cropped off."""
    h0, w0 = sais.shape[1] // ang, sais.shape[2] // ang
    x, p = _whole_pad_batch(sais, ang, whole_pad)
    with torch.inference_mode():
        sr = model(x[..., None])[..., 0]
    v = sai_to_views(sr, ang_out)
    if p:
        ps = p * scale
        v = v[..., ps : ps + h0 * scale, ps : ps + w0 * scale]
    return v


def sr_scenes_whole(model, lr_sais: torch.Tensor, *, ang: int, ang_out: int, scale: int = 1,
                    whole_pad: int = 0, minibatch: int = 2) -> torch.Tensor:
    """Whole-scene SR of same-geometry scenes ``lr_sais`` [N, A*h0, A*w0],
    ``minibatch`` scenes per model call (the scene count is zero-padded to
    a multiple of it and cut back). Returns [N, A_out, A_out, h0*s, w0*s]."""
    n = lr_sais.shape[0]
    mb = max(1, min(minibatch, n))
    n_pad = -(-n // mb) * mb
    sais = torch.nn.functional.pad(lr_sais, (0, 0, 0, 0, 0, n_pad - n))
    outs = [_whole_run(model, sais[i : i + mb], ang, ang_out, scale, whole_pad)
            for i in range(0, n_pad, mb)]
    return torch.cat(outs)[:n]


def sr_scene(model, lr_sai: torch.Tensor, *, ang: int, scale: int, patch: int, stride: int,
             minibatch: int, h0: int, w0: int, ang_out: int | None = None,
             integrate: str = "crop", integrate_sigma: float | None = None,
             whole_pad: int = 0, whole: bool = False) -> torch.Tensor:
    """Super-resolve one scene. ``lr_sai`` [A*h0, A*w0] float32 on the
    model's device; returns SR views [A_out, A_out, h0*s, w0*s]. ``whole``
    runs the mosaic un-tiled (padded by ``whole_pad``); otherwise tiled."""
    ang_out = ang_out or ang
    if whole:
        return _whole_run(model, lr_sai[None], ang, ang_out, scale, whole_pad)[0]
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
    if cfg.task != "SR":
        raise NotImplementedError(f"task {cfg.task!r}: only SR evaluation is ported")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _sr_one(model, scene, cfg: Config) -> torch.Tensor:
    """SR views [A_out, A_out, h0*s, w0*s] of one TestScene, whole-scene or
    tiled as ``cfg`` says."""
    ang = cfg.angRes
    lr = torch.as_tensor(np.asarray(scene.lr_y, np.float32), device=_device_of(model))
    return sr_scene(
        model, lr, ang=ang, scale=cfg.scale_factor, patch=cfg.patch_size_for_test,
        stride=cfg.stride_for_test, minibatch=cfg.minibatch_for_test,
        h0=scene.lr_y.shape[0] // ang, w0=scene.lr_y.shape[1] // ang, ang_out=cfg.angRes_out,
        integrate="gaussian" if cfg.epsw_for_test else "crop", integrate_sigma=cfg.epsw_sigma,
        whole_pad=cfg.whole_scene_pad, whole=whole_scene_default(cfg),
    )


def evaluate_scene(model, scene, cfg: Config):
    """SR + metrics for one TestScene. Returns (psnr, ssim, sr_views)."""
    _check_ported(cfg)
    views = _sr_one(model, scene, cfg)
    p, ssim_v = _score_views(scene, views, cfg.angRes, cfg.angRes_out, cfg.scale_factor)
    return p, ssim_v, views


def _score_views(scene, sr_views, ang, ang_out, s):
    h0 = scene.lr_y.shape[0] // ang
    w0 = scene.lr_y.shape[1] // ang
    sr_sai = sr_views.movedim(2, 1).reshape(ang_out * h0 * s, ang_out * w0 * s)
    hr = torch.as_tensor(np.asarray(scene.hr_y[: ang_out * h0 * s, : ang_out * w0 * s],
                                    np.float32), device=sr_views.device)
    p, ssim_v = lf_metrics(hr, sr_sai, ang)
    return float(p), float(ssim_v)


def sr_groups_whole(model, scenes, cfg: Config):
    """Whole-scene SR of ``scenes``: groups of the same LR mosaic shape, in
    first-seen order, ``whole_scene_minibatch`` scenes per model call;
    yields (scene, SR views)."""
    groups: dict = {}
    for sc in scenes:
        groups.setdefault(sc.lr_y.shape, []).append(sc)
    dev = _device_of(model)
    for group in groups.values():
        batch = torch.as_tensor(np.stack([np.asarray(sc.lr_y, np.float32) for sc in group]),
                                device=dev)
        views = sr_scenes_whole(
            model, batch, ang=cfg.angRes, ang_out=cfg.angRes_out, scale=cfg.scale_factor,
            whole_pad=cfg.whole_scene_pad, minibatch=cfg.whole_scene_minibatch,
        )
        yield from zip(group, views)


def sr_views(model, scenes, cfg: Config):
    """Yields (scene, SR views) for ``scenes``: scene-batched whole-scene SR
    (:func:`sr_groups_whole`, grouped by geometry) when ``cfg`` selects
    whole-scene mode, else one tiled scene at a time."""
    _check_ported(cfg)
    if whole_scene_default(cfg):
        yield from sr_groups_whole(model, scenes, cfg)
    else:
        for sc in scenes:
            yield sc, _sr_one(model, sc, cfg)


def evaluate_sets(model, scenes_by_set: dict, cfg: Config, log=print,
                  keep_views: bool = False) -> dict:
    """Per-dataset averages. Returns ``{set: {"psnr", "ssim", "scenes":
    [(name, psnr, ssim), ...]}}`` with the scenes in input order, plus
    ``"views": {scene name: SR views}`` with ``keep_views``."""
    results = {}
    for name, scenes in scenes_by_set.items():
        scored, views = {}, {}
        for sc, v in sr_views(model, scenes, cfg):
            p, s = scored[sc.name] = _score_views(sc, v, cfg.angRes, cfg.angRes_out,
                                                  cfg.scale_factor)
            if keep_views:
                views[sc.name] = v
            log(f"  {name}/{sc.name}: PSNR {p:.3f} SSIM {s:.4f}")
        per_scene = [(sc.name, *scored[sc.name]) for sc in scenes]
        avg_p = float(np.mean([x[1] for x in per_scene]))
        avg_s = float(np.mean([x[2] for x in per_scene]))
        results[name] = {"psnr": avg_p, "ssim": avg_s, "scenes": per_scene}
        if keep_views:
            results[name]["views"] = views
        log(f"  {name} average: PSNR {avg_p:.3f} SSIM {avg_s:.4f}")
    return results

"""The benchmark's inputs, made with numpy from ``--seed``.

A light field here is a smooth random texture (six sinusoids) seen by a
5 x 5 grid of views, each shifted by its own disparity; its LR views are
4 x 4 box means of the HR ones. Scenes of the NTIRE test geometries and
the SAI-160 training pairs both come from it. The sizes of a mix are
fixed by its traffic file; the seed changes the textures and the order,
never the sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ANG, SCALE = 5, 4


@dataclass
class Scene:
    """One test scene: its LR SAI mosaic [A*h, A*w] float32 (the field the
    program's evaluation reads) and its geometry's name."""
    name: str
    subset: str
    lr_y: np.ndarray


def light_fields(rng: np.random.Generator, n: int, hr: tuple[int, int], device="cpu"):
    """``n`` light fields of HR views ``hr`` = (height, width): (LR SAI
    mosaics [n, A*h/4, A*w/4], HR SAI mosaics [n, A*h, A*w]), float32
    numpy arrays. The draws come from ``rng``; the arithmetic runs on
    ``device`` in a few bulk operations."""
    h, w = hr
    pad = 16
    f = rng.uniform(0.005, 0.05, (6, 2, n)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (6, n)).astype(np.float32)
    amp = rng.uniform(0.2, 1.0, (6, n)).astype(np.float32)
    disp = rng.uniform(0.5, 1.5, n)
    t = lambda a: torch.as_tensor(a, device=device)
    yy = torch.arange(h + 2 * pad, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w + 2 * pad, dtype=torch.float32, device=device)[None, None, :]
    tex = torch.zeros((n, h + 2 * pad, w + 2 * pad), device=device)
    for k in range(6):
        fy, fx = t(f[k, 0])[:, None, None], t(f[k, 1])[:, None, None]
        tex += t(amp[k])[:, None, None] * torch.sin(
            2 * np.pi * (fy * yy + fx * xx) + t(ph[k])[:, None, None])
    lo = tex.amin(dim=(1, 2), keepdim=True)
    tex = (tex - lo) / (tex.amax(dim=(1, 2), keepdim=True) - lo)
    items = torch.arange(n, device=device)[:, None, None]
    rows0, cols0 = torch.arange(h, device=device), torch.arange(w, device=device)
    views = torch.empty((n, ANG, ANG, h, w), device=device)
    for u in range(ANG):
        for v in range(ANG):
            dy = t(np.rint(disp * (u - ANG // 2)).astype(np.int64) + pad)
            dx = t(np.rint(disp * (v - ANG // 2)).astype(np.int64) + pad)
            views[:, u, v] = tex[items, (dy[:, None] + rows0)[:, :, None],
                                 (dx[:, None] + cols0)[:, None, :]]
    lr = views.reshape(n, ANG, ANG, h // SCALE, SCALE, w // SCALE, SCALE).mean(dim=(4, 6))
    to_sai = lambda a: a.permute(0, 1, 3, 2, 4).reshape(n, ANG * a.shape[3], ANG * a.shape[4])
    return to_sai(lr).cpu().numpy(), to_sai(views).cpu().numpy()


def vary_contrast(rng: np.random.Generator, lr: np.ndarray, hr: np.ndarray, lo: float,
                  hi: float):
    """Each item's LR and HR scaled by its own contrast c in [lo, hi] and
    lifted by an offset in [0, 1 - c], as patches of sky and of texture
    differ in a real training set. In place; returns (lr, hr)."""
    n = lr.shape[0]
    c = rng.uniform(lo, hi, n).astype(np.float32)
    o = (rng.uniform(0, 1, n) * (1 - c)).astype(np.float32)
    lr *= c[:, None, None]
    lr += o[:, None, None]
    hr *= c[:, None, None]
    hr += o[:, None, None]
    return lr, hr


def test_scenes(rng: np.random.Generator, geometries: list, device="cpu") -> list[Scene]:
    """The scenes of ``geometries`` ([{"subset", "hr", "scenes"}]), each
    subset's in one bulk draw."""
    out = []
    for g in geometries:
        lr, _ = light_fields(rng, g["scenes"], tuple(g["hr"]), device)
        out += [Scene(f"{g['subset']}_{i:02d}", g["subset"], np.ascontiguousarray(lr[i]))
                for i in range(g["scenes"])]
    return out

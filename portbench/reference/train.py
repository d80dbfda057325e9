"""The training step in plain float32 PyTorch: the benchmark's reference.

What one step of the configuration's recipe does, written out again:

- the epoch's random streams (permutation on the host; augmentation, view
  masks, SRACM and dropout on the device), each a ``torch.Generator``
  seeded from (seed, epoch, stream) through numpy's ``SeedSequence``;
- the batch: rows of an epoch permutation of the training set, in order;
- augmentation: per item a W-flip, an H-flip and a transpose of the whole
  SAI mosaic, each with probability 1/2, the same for LR and HR;
- masked angular pre-training (epoch e: ratio 0.1 + 0.2 min(1, e / 20)):
  ``max(1, int(25 ratio))`` non-centre views zeroed in random order, the
  same for the batch, with probability 1/2; SRACM zeroes one random
  spatial mask (each pixel with probability ``ratio``) in every view;
- the model in training mode (dropout 0.1 in each block for the flagship),
  the loss (``composite_v8``: Charbonnier + 0.1 |FFT| L1 + 0.02 (1 - SSIM,
  7x7 box) + 0.04 Sobel L1 + 0.06 angular-difference L1; or plain L1);
- the optimizer: the gradient clipped to global norm 1 (g / ||g|| when
  ||g|| >= 1), AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay
  1e-4 on every parameter, bias correction with the step count) at a
  linear warm-up from lr/100 to lr over min(5, epochs // 10) epochs, then
  cosine to min_lr; a step with a non-finite gradient changes nothing.

:func:`follow` runs the first ``steps`` steps of epoch 0 and returns the
losses, the first clipped gradient's leaf norms and each leaf's change.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import F32, Prec, sai_to_views

B1, B2, EPS = 0.9, 0.999, 1e-8
STREAMS = ("permutation", "augment", "mask", "sracm", "dropout")


def generators(seed: int, epoch: int, device) -> dict:
    out = {}
    for i, name in enumerate(STREAMS):
        s = int(np.random.SeedSequence([seed, epoch, i]).generate_state(1)[0])
        dev = "cpu" if name == "permutation" else device
        out[name] = torch.Generator(device=dev).manual_seed(s)
    return out


def batch_rows(gen, n: int, batch: int, steps: int) -> torch.Tensor:
    perm = torch.randperm(n, generator=gen, device=gen.device)
    reps = -(-steps * batch // n)
    return perm.repeat(reps)[: steps * batch].reshape(steps, batch)


def augment(gen, lr, hr):
    flags = torch.rand((3, lr.shape[0]), generator=gen, device=gen.device) < 0.5

    def one(x):
        fw, fh, ft = (f[:, None, None] for f in flags)
        x = torch.where(fw, x.flip(2), x)
        x = torch.where(fh, x.flip(1), x)
        return torch.where(ft, x.transpose(1, 2), x)

    return one(lr), one(hr)


def view_keep(gen, ang: int, k: int) -> torch.Tensor:
    """[A, A] float32: 0 on k views drawn in random order (never the
    centre), or all ones with probability 1/2."""
    dev = gen.device
    pri = torch.rand(ang * ang, generator=gen, device=dev).clone()
    pri[(ang // 2) * ang + ang // 2] = float("inf")
    order = torch.argsort(pri)
    apply = torch.rand((), generator=gen, device=dev) < 0.5
    masked = torch.zeros(ang * ang, dtype=torch.bool, device=dev)
    masked[order[:k]] = True
    keep = (~masked).to(torch.float32).reshape(ang, ang)
    return torch.where(apply, keep, torch.ones_like(keep))


def mask_views(x, keep, ang: int):
    b, H, W, c = x.shape
    v = x.reshape(b, ang, H // ang, ang, W // ang, c)
    return (v * keep.reshape(1, ang, 1, ang, 1, 1)).reshape(x.shape)


def sracm(gen, x, ang: int, ratio: float):
    h, w = x.shape[1] // ang, x.shape[2] // ang
    keep = torch.rand((h, w), generator=gen, device=gen.device) >= ratio
    return x * keep.to(x.dtype).repeat(ang, ang)[None, :, :, None]


# ---------------------------------------------------------------------------
# losses, on NHWC SAI mosaics [B, A*H, A*W, 1]
# ---------------------------------------------------------------------------

def _box(a, window: int = 7):
    p = window // 2

    def along(x, axis):
        n = x.shape[axis]
        xp = F.pad(x, [0, 0] * (x.dim() - axis - 1) + [p, p])
        acc = xp.narrow(axis, 0, n)
        for k in range(1, window):
            acc = acc + xp.narrow(axis, k, n)
        return acc

    return along(along(a, 1), 2) / (window * window)


def _shift(x, axis: int, d: int):
    n = x.shape[axis]
    return F.pad(x, [0, 0] * (x.dim() - axis - 1) + [max(d, 0), max(-d, 0)]).narrow(
        axis, max(-d, 0), n)


def _sobel(a, axis: int):
    other = 3 - axis
    s = _shift(a, other, 1) + 2.0 * a + _shift(a, other, -1)
    return _shift(s, axis, -1) - _shift(s, axis, 1)


def l1(sr, hr):
    return (sr - hr).abs().mean()


def composite_v8(sr, hr, ang: int = 5):
    d = sr - hr
    out = torch.sqrt(d * d + 1e-18).mean()
    fs = torch.fft.rfft2(sr, dim=(1, 2)).abs()
    fh = torch.fft.rfft2(hr, dim=(1, 2)).abs()
    out = out + 0.1 * (fs - fh).abs().mean()
    c1, c2 = 0.01**2, 0.03**2
    mx, my = _box(sr), _box(hr)
    vx = torch.clamp_min(_box(sr * sr) - mx * mx, 0)
    vy = torch.clamp_min(_box(hr * hr) - my * my, 0)
    vxy = _box(sr * hr) - mx * my
    ssim = ((2 * mx * my + c1) * (2 * vxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    out = out + 0.02 * (1.0 - ssim.mean())
    grad = ((_sobel(sr, 2) - _sobel(hr, 2)).abs().mean()
            + (_sobel(sr, 1) - _sobel(hr, 1)).abs().mean())
    out = out + 0.04 * grad
    if sr.shape[1] % ang == 0 and sr.shape[2] % ang == 0:
        sv, hv = sai_to_views(sr[..., 0], ang), sai_to_views(hr[..., 0], ang)
        ac = ((torch.diff(sv, dim=1) - torch.diff(hv, dim=1)).abs().mean()
              + (torch.diff(sv, dim=2) - torch.diff(hv, dim=2)).abs().mean())
        out = out + 0.06 * ac
    return out


LOSSES = {"composite_v8": composite_v8, "l1": l1}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@dataclass
class Hyper:
    lr: float
    min_lr: float
    weight_decay: float
    clip: float
    epochs: int
    warmup_epochs: int | None
    mask_start: float
    mask_end: float
    mask_warmup: int
    masked: bool
    augment: bool
    ang: int

    @staticmethod
    def of(cfg) -> "Hyper":
        return Hyper(cfg.lr, cfg.min_lr, cfg.weight_decay, cfg.grad_clip_norm, cfg.epochs,
                     cfg.warmup_epochs, cfg.mask_start_ratio, cfg.mask_end_ratio,
                     cfg.mask_warmup_epochs, cfg.use_masked_pretrain, cfg.augment, cfg.angRes)


def learning_rate(h: Hyper, spe: int, count: int) -> float:
    warm_e = min(5, h.epochs // 10) if h.warmup_epochs is None else h.warmup_epochs
    warm = max(1, warm_e * spe)
    total = max(warm + 1, h.epochs * spe)
    lo = h.lr * 0.01
    if count < warm:
        return lo + (h.lr - lo) * count / warm
    t = min(count - warm, total - warm)
    alpha = h.min_lr / h.lr
    return h.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / (total - warm))) + alpha)


def adamw_step(p: dict, g: dict, mu: dict, nu: dict, count: int, lr: float, h: Hyper) -> dict:
    """One update of ``p`` in place; returns the gradient as clipped."""
    flat = torch.cat([v.reshape(-1) for v in g.values()])
    if not bool(torch.isfinite(flat).all()):
        return g
    norm = float(torch.linalg.vector_norm(flat))
    if norm >= h.clip:
        g = {k: v / norm * h.clip for k, v in g.items()}
    c = count + 1
    for k in p:
        mu[k] = (1 - B1) * g[k] + B1 * mu[k]
        nu[k] = (1 - B2) * g[k] * g[k] + B2 * nu[k]
        upd = (mu[k] / (1 - B1**c)) / (torch.sqrt(nu[k] / (1 - B2**c)) + EPS) + h.weight_decay * p[k]
        p[k] -= lr * upd
    return g


def follow(ref, weights: dict, lr_np, hr_np, *, kw: dict, seed: int, steps: int, spe: int,
           batch: int, loss: str, hyper: Hyper, dropout: bool, q: Prec = F32,
           device="cuda", rows_at_once: int = 4) -> dict:
    """The first ``steps`` steps of epoch 0 from ``weights`` on the training
    set (lr_np [n, A*h, A*w], hr_np [n, A*H, A*W]). Returns {"losses":
    [...], "g1": first clipped gradient's leaf norms, "change": each leaf's
    change after the last step, as norms}. The batch goes through the model
    ``rows_at_once`` rows at a time, the gradients summed (every term of the
    losses is a mean over equal parts of the batch), so that a step fits."""
    ang = hyper.ang
    p = {k: v.detach().clone() for k, v in weights.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    gens = generators(seed, 0, device)
    rows = batch_rows(gens["permutation"], lr_np.shape[0], batch, spe)
    ratio = hyper.mask_start if hyper.masked else 0.0
    k = max(1, int(ang * ang * ratio)) if ratio > 0 else 0
    lr_all, hr_all = torch.as_tensor(lr_np, device=device), torch.as_tensor(hr_np, device=device)
    losses, g1 = [], None
    for i in range(steps):
        idx = rows[i].to(device)
        lr, hr = lr_all[idx], hr_all[idx]
        if hyper.augment:
            lr, hr = augment(gens["augment"], lr, hr)
        x, y = lr[..., None], hr[..., None]
        if k:
            x = mask_views(x, view_keep(gens["mask"], ang, k), ang)
            x = sracm(gens["sracm"], x, ang, ratio)
        leaves = {n: v.requires_grad_() for n, v in p.items()}
        masks = None
        if dropout:  # drawn for the whole batch, block by block, before the forward
            masks = ref.dropout_masks(gens["dropout"], (batch, *x.shape[1:3], kw.get("channels", 64)),
                                      kw)
        value, grads = 0.0, None
        for r0 in range(0, batch, rows_at_once):
            part = slice(r0, r0 + rows_at_once)
            share = x[part].shape[0] / batch
            with torch.enable_grad():
                extra = ({"dropout": [m[part] for m in masks], "remat": True}
                         if masks is not None else {})
                sr = ref.forward(leaves, x[part], kw, ang, q=q, **extra)
                v = LOSSES[loss](sr, y[part]) * share
                gs = torch.autograd.grad(v, list(leaves.values()))
            value += float(v.detach())
            grads = gs if grads is None else [a + b for a, b in zip(grads, gs)]
            del sr, v, gs
        p = {n: v.detach() for n, v in leaves.items()}
        g = adamw_step(p, dict(zip(p, grads)), mu, nu, i, learning_rate(hyper, spe, i), hyper)
        if g1 is None:
            g1 = {n: float(torch.linalg.vector_norm(v)) for n, v in g.items()}
        losses.append(value)
    change = {n: float(torch.linalg.vector_norm(p[n] - weights[n])) for n in p}
    return {"losses": losses, "g1": g1, "change": change}

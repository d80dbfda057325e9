"""What decides ``correct``: the program's outputs against the plain
reference, number by number, each against its limit (``limits/<cell>.json``).

Evaluation cells compare SR views: ``sr_gap`` is, for each sampled scene,
|| SR_program - SR_ref || / || SR_ref@dtype - SR_ref || over all
of its views (L2), where SR_ref is the float32 reference and SR_ref@dtype
the same reference holding its activations and weights in the
configuration's compute dtype (``reference.common.Prec``): the program's
distance from float32 in units of the distance that rounding to its own
dtype makes by itself. A sound program reads about 1; the control (the
reference at the dtype below, put in the program's place) reads far more.
The units make the number steady from seed to seed, where a plain relative
error moves with the random weights' scale. The cell's number is the
largest over the sample.

The training cell compares the program's first steps (read from its own
state while set-up runs them through ``run_epoch``) with the reference's
on the same rows and draws (:func:`reference_steps`):

- ``loss_gap``: the largest, over the steps, of |loss - loss_ref| / |loss_ref|;
- ``grad_gap``: the first gradient as the optimizer takes it (after the
  clip), worked out from the first moment after one step (g = mu / (1 -
  b1)), leaf by leaf: | ||g|| - ||g_ref|| | over max(||g_ref||, the
  median leaf's ||g_ref||), at the median leaf (the worst leaf is a
  one-element scale whose gradient is a sum over a whole map that cancels
  nearly to nothing, so bfloat16's rounding moves it by 5-20% from seed to
  seed: PERF.md);
- ``change_gap``: the same for each leaf's change over the followed steps,
  at the worst leaf, leaving out the leaves whose reference gradient is
  under 1e-3 of the median leaf's (they move by round-off alone under
  Adam): a leaf left unmoved, moved double or moved wrongly reads about 1.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench.reference import common
from portbench.reference import train as ref_train

REF_BATCH = 8  # tiled patches a reference call takes


@contextlib.contextmanager
def exact_float32():
    """float32 products and convolutions without TF32, then the settings as
    they were."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def whole_views(ref, p, lr, kw, ang, s, pad, q):
    """A whole scene's SR views [A, A, h0*s, w0*s]: the mosaic padded as
    the whole-scene protocol pads it, through the reference, cropped."""
    h0, w0 = lr.shape[0] // ang, lr.shape[1] // ang
    x, pp = common.whole_pad(lr, ang, pad)
    v = common.sai_to_views(ref.forward(p, x[None, ..., None], kw, ang, s, q=q)[0, ..., 0], ang)
    return v[..., pp * s : pp * s + h0 * s, pp * s : pp * s + w0 * s]


def tiled_views(ref, p, lr, kw, ang, s, patch, stride, q):
    """A scene's SR views by the tiled protocol: overlapping LR patches
    through the reference, the SR patches' centres stitched."""
    h0, w0 = lr.shape[0] // ang, lr.shape[1] // ang
    patches = common.divide(lr, ang, patch, stride)
    outs = [ref.forward(p, patches[i : i + REF_BATCH, ..., None], kw, ang, s, q=q)[..., 0]
            for i in range(0, patches.shape[0], REF_BATCH)]
    return common.integrate(torch.cat(outs), ang, patch * s, stride * s, h0 * s, w0 * s)


def sr_gap(got, want, base) -> float:
    """|| got - want || / || base - want ||: ``want`` the float32
    reference's output, ``base`` the reference's at the configuration's
    compute dtype (for a float32 configuration, ``want`` itself: then the
    unit is float32's rounding, 2^-24 of || want ||)."""
    num = torch.linalg.vector_norm(got.float() - want)
    den = torch.linalg.vector_norm(base - want)
    if base is want:
        den = torch.linalg.vector_norm(want) * 2.0**-24
    return float(num / den)


def own_precision(cfg) -> common.Prec:
    """The reference's rounding at the configuration's compute dtype."""
    return common.Prec(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


class Follow:
    """Within the block, reads the trainer's first ``steps`` steps from its
    own state: each step's loss, the first gradient's leaf norms (from the
    first moment after step 1) and each leaf's change after the last
    followed step. ``fault="half_batch"`` plants a fault in the program for
    a calibration: the loss over half of each batch."""

    def __init__(self, trainer, p0: dict, steps: int, fault: str | None = None):
        self.trainer, self.p0, self.steps, self.fault = trainer, p0, steps, fault
        self.losses, self.g1, self.change = [], None, None

    def __enter__(self):
        tr = self.trainer
        step, opt_step, loss_fn = tr.train_step, tr.opt.step_, tr.loss_fn
        calls = {"opt": 0}

        def train_step(*a, **k):
            m = step(*a, **k)
            if len(self.losses) < self.steps:
                self.losses.append(float(m["loss"]))
            return m

        def step_(params, grads, state):
            opt_step(params, grads, state)
            calls["opt"] += 1
            if calls["opt"] == 1:
                self.g1 = _leaf_norms({k: v / (1 - ref_train.B1) for k, v in state.mu.items()})
            if calls["opt"] == self.steps:
                self.change = _leaf_norms({k: params[k].detach() - self.p0[k] for k in params})

        tr.train_step, tr.opt.step_ = train_step, step_
        self._loss_fn = loss_fn
        if self.fault == "half_batch":
            tr.loss_fn = lambda sr, hr: loss_fn(sr[: sr.shape[0] // 2], hr[: hr.shape[0] // 2])
        return self

    def __exit__(self, *exc):
        del self.trainer.train_step, self.trainer.opt.step_
        self.trainer.loss_fn = self._loss_fn

    def readings(self) -> dict:
        return {"losses": self.losses, "g1": self.g1, "change": self.change}


def reference_steps(loop, q) -> dict:
    """The reference's first steps on the program's rows and draws, worked
    out again from the seed (``reference/train.py``)."""
    cfg = loop.cfg
    return ref_train.follow(
        loop.ref, loop.weights, loop.data.lr, loop.data.hr, kw=loop.kw, seed=cfg.seed,
        steps=loop.cell.traffic["check_steps"], spe=loop.spe, batch=cfg.batch_size,
        loss=loop.cell.config["loss"], hyper=ref_train.Hyper.of(cfg),
        dropout=loop.cell.config.get("dropout", False), q=q, device=loop.device)


def worst_leaves(got: dict, want: dict, n: int = 4) -> dict:
    """The leaves with the largest gradient and change gaps, largest first:
    {number: [(leaf, gap, program's norm, reference's norm)]}."""
    out = {}
    g_med = float(np.median(list(want["g1"].values())))
    for key, name in (("g1", "grad_gap"), ("change", "change_gap")):
        keep = (list(want["g1"]) if key == "g1"
                else [k for k, v in want["g1"].items() if v >= 1e-3 * g_med])
        med = float(np.median([want[key][k] for k in keep]))
        gaps = sorted(((abs(got[key][k] - want[key][k]) / max(want[key][k], med), k) for k in keep),
                      reverse=True)[:n]
        out[name] = [(k, g, got[key][k], want[key][k]) for g, k in gaps]
    return out


def train_gaps(got: dict, want: dict) -> dict:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))

    def leaf_gaps(a: dict, b: dict, keep) -> list:
        """Each leaf's | ||a|| - ||b|| | / max(||b||, median ||b||)."""
        med = float(np.median([b[k] for k in keep]))
        return [abs(a[k] - b[k]) / max(b[k], med) for k in keep]

    g_med = float(np.median(list(want["g1"].values())))
    moved = [k for k, v in want["g1"].items() if v >= 1e-3 * g_med]
    out = {"loss_gap": loss_gap,
           "grad_gap": float(np.median(leaf_gaps(got["g1"], want["g1"], list(want["g1"])))),
           "change_gap": float(max(leaf_gaps(got["change"], want["change"], moved)))}
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}

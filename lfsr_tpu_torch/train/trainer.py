"""Trainer (port of lfsr_tpu/train/trainer.py:82-278): the train step and
the epoch loop, on one device.

One step, as the JAX ``_build_step``: gather the batch by index on the
device, augment (flips and transpose), mask views and SRACM when the epoch
masks (``mask_k > 0``), forward in train mode (the flagship's dropout; a
model outside ``_TRAIN_FLAG_MODELS`` is called as ``model(x)``), the
model's registered loss, backward, the optimizer (clip, AdamW, NaN-skip), and
PSNR/SSIM of the batch under ``no_grad`` (per-view PSNR only when a view is
under the 11-pixel SSIM window). Nothing in a step reads a value back to
the host: a run of steps queues on the device, and ``run_epoch`` reads
the metrics once at the end.

Every stage runs in a span (``trace.span``): in ``run_epoch``'s loop
``train.gather`` and ``train.draw``, then ``train.step`` around the step's
``train.augment``, ``train.forward``, ``train.loss``, ``train.backward``
(the ``autograd.grad`` call), ``train.optimizer`` and ``train.metrics``;
the epoch's one host read is ``train.readback``. Host data goes up
through ``trace.upload``.

Random streams: one ``torch.Generator`` each for the permutation (on the
CPU) and for augmentation, view masks, SRACM and dropout (on the device),
seeded from ``cfg.seed``, the epoch and the stream (:func:`generators`).
The numbers differ from ``jax.random``'s; tests feed both sides the same
draws through :class:`Draws`.

Checkpoints (:func:`save_checkpoint`, :func:`latest_checkpoint`,
:func:`restore_checkpoint`) carry the full state, as the JAX package's
orbax ones do: the parameters, the optimizer state (both moments,
``count``, ``notfinite_count``, ``last_finite``, ``total_notfinite``), the
step and the epoch, as ``checkpoints/epoch_%04d.pt`` (``torch.save``, read
back with ``weights_only=True``). Restoring also takes a JAX checkpoint
exported to ``.npz`` by ``scripts/export_npz.py``: the flax param tree
under ``params/<scope>/.../<leaf>`` keys, optax's first and second moments
under ``mu/...`` and ``nu/...`` with the same paths, and ``count``,
``notfinite_count``, ``last_finite``, ``total_notfinite``, ``step`` and
``epoch``; the parameters and both moments go through
``bridge.state_dict_from_flax`` (keys and layouts). The per-epoch
generators make a resumed run draw what an uninterrupted one draws.

Not ported yet: multi-device data parallelism.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import state_dict_from_flax
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.data.datasets import (
    TrainArrays, apply_augment, batch_indices, draw_augment,
)
from lfsr_tpu_torch.models.registry import get_loss, get_model
from lfsr_tpu_torch.ops.layout import sai_to_views
from lfsr_tpu_torch.ops.metrics import lf_metrics, psnr
from lfsr_tpu_torch.train import masking
from lfsr_tpu_torch.train.optim import Optimizer

STREAMS = ("permutation", "augment", "mask", "sracm", "dropout")

# Models whose forward takes the train-mode dropout generator (the JAX
# trainer's ``_TRAIN_FLAG_MODELS``: their __call__ accepts ``train``); every
# other model is called as ``model(x)``.
_TRAIN_FLAG_MODELS = {
    "LFMambaX", "EfficientLFNetV2", "EfficientLFNetV3", "EfficientLFNetV64",
    "EfficientLFNetV6", "EfficientLFNetV6_1", "EfficientLFNetV6_3",
    "EfficientLFNetV6_5", "EfficientLFNetV7", "LF_DET",
}


def generators(cfg: Config, epoch: int, device) -> dict[str, torch.Generator]:
    """One generator per random stream of an epoch; the permutation's on
    the CPU, the others on ``device``."""
    out = {}
    for i, name in enumerate(STREAMS):
        seed = int(np.random.SeedSequence([cfg.seed, epoch, i]).generate_state(1)[0])
        dev = "cpu" if name == "permutation" else device
        out[name] = torch.Generator(device=dev).manual_seed(seed)
    return out


@dataclass
class Draws:
    """The random inputs of one step; None turns a stage off."""
    flips: torch.Tensor | None = None       # [3, B] bool (augment)
    view_keep: torch.Tensor | None = None   # [A, A] float32 (view masking)
    sracm_keep: torch.Tensor | None = None  # [h, w] bool (SRACM)


class Trainer:
    """``Trainer(cfg, steps_per_epoch, state_dict, device)``: the model in
    train mode with the given parameters, its loss, and the optimizer
    state, on the card unless ``device="cpu"``. ``trainer.model.eval()``
    turns dropout off (parity tests). ``step`` counts the steps taken, the
    skipped ones too (the JAX ``TrainState.step``)."""

    def __init__(self, cfg: Config, steps_per_epoch: int, state_dict: dict, device="cuda"):
        self.cfg, self.steps_per_epoch, self.device = cfg, steps_per_epoch, torch.device(device)
        self.model = get_model(cfg, device=self.device)
        self.model.load_state_dict(state_dict)
        self.model.train()
        self.loss_fn = get_loss(cfg)
        self.params = dict(self.model.named_parameters())
        self.opt = Optimizer(cfg, steps_per_epoch)
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        self._data = None  # (data, lr, hr) staged on the device

    def draw(self, gens: dict, lr_shape, mask_k: int, ratio: float) -> Draws:
        """This step's draws, as the config and the epoch's mask count ask."""
        cfg, ang = self.cfg, self.cfg.angRes
        d = Draws()
        if cfg.augment:
            d.flips = draw_augment(gens["augment"], lr_shape[0])
        if cfg.use_masked_pretrain and mask_k > 0:
            d.view_keep = masking.draw_view_mask(gens["mask"], ang, mask_k, cfg.mask_strategy)
            d.sracm_keep = masking.draw_sracm(gens["sracm"], lr_shape[1] // ang,
                                              lr_shape[2] // ang, ratio)
        return d

    def forward(self, x: torch.Tensor, dropout: torch.Generator | None = None) -> torch.Tensor:
        """The model on x, with the dropout generator for the models that
        take one (``_TRAIN_FLAG_MODELS``)."""
        if self.cfg.model_name in _TRAIN_FLAG_MODELS:
            return self.model(x, generator=dropout)
        return self.model(x)

    def train_step(self, lr: torch.Tensor, hr: torch.Tensor, draws: Draws,
                   dropout: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """One optimizer step on lr [B, A*h, A*w] / hr [B, A*H, A*W] float32
        (on the device). Returns the batch's loss, PSNR and SSIM as device
        scalars (the loss and metrics of the parameters before the step)."""
        with trace.span("train.step"):
            ang, ao = self.cfg.angRes, self.cfg.angRes_out
            with trace.span("train.augment"):
                if draws.flips is not None:
                    lr, hr = apply_augment(lr, hr, draws.flips)
                x, y = lr[..., None], hr[..., None]
                if draws.view_keep is not None:
                    x = masking.apply_view_mask(x, draws.view_keep, ang)
                if draws.sracm_keep is not None:
                    x = masking.apply_sracm(x, draws.sracm_keep, ang)
            with trace.span("train.forward"):
                sr = self.forward(x, dropout)
            with trace.span("train.loss"):
                loss = self.loss_fn(sr, y)
            with trace.span("train.backward"):
                grads = torch.autograd.grad(loss, list(self.params.values()))
                grads = dict(zip(self.params, grads))
            with trace.span("train.optimizer"):
                self.opt.step_(self.params, grads, self.opt_state)
                self.step += 1
            with trace.span("train.metrics"), torch.no_grad():
                if y.shape[1] // ao >= 11 and y.shape[2] // ao >= 11:
                    p, s = lf_metrics(y[..., 0], sr[..., 0], ao)
                else:  # views under the 11-tap SSIM window: per-view PSNR only
                    p = psnr(sai_to_views(y[..., 0], ao), sai_to_views(sr[..., 0], ao)).mean()
                    s = torch.zeros((), device=sr.device)
                return {"loss": loss.detach(), "psnr": p, "ssim": s}

    def _on_device(self, data: TrainArrays) -> bool:
        """Stage the whole training set on the device once (per data
        object) when it is under ``model_kwargs['device_data_gb']`` (4 GB)."""
        limit = float(self.cfg.mk("device_data_gb", 4.0)) * 1e9
        if data.lr.nbytes + data.hr.nbytes > limit:
            return False
        if self._data is None or self._data[0] is not data:
            self._data = (data, trace.upload(data.lr, self.device),
                          trace.upload(data.hr, self.device))
        return True

    def run_epoch(self, data: TrainArrays, epoch: int) -> dict[str, float]:
        """``steps_per_epoch`` steps over a fresh permutation of ``data``;
        returns the mean loss/PSNR/SSIM and the epoch's mask ratio."""
        cfg = self.cfg
        ratio = (masking.progressive_ratio(epoch, cfg.mask_start_ratio, cfg.mask_end_ratio,
                                           cfg.mask_warmup_epochs)
                 if cfg.use_masked_pretrain else 0.0)
        mask_k = masking.num_masked_views(cfg.angRes, ratio) if ratio > 0 else 0
        gens = generators(cfg, epoch, self.device)
        idx = batch_indices(gens["permutation"], len(data), cfg.batch_size, self.steps_per_epoch)
        if self._on_device(data):  # the batch gather runs on the device
            _, lr_all, hr_all = self._data
            idx = trace.upload(idx, self.device)
            batch = lambda i: (lr_all[idx[i]], hr_all[idx[i]])
        else:  # host gather, one batch copied per step
            batch = lambda i: (trace.upload(data.lr[idx[i].numpy()], self.device),
                               trace.upload(data.hr[idx[i].numpy()], self.device))
        steps = []
        for i in range(self.steps_per_epoch):
            with trace.span("train.gather"):
                lr, hr = batch(i)
            with trace.span("train.draw"):
                draws = self.draw(gens, lr.shape, mask_k, ratio)
            steps.append(self.train_step(lr, hr, draws, gens["dropout"]))
        with trace.span("train.readback"):
            out = {k: float(torch.stack([m[k] for m in steps]).mean())
                   for k in (steps[0] if steps else ())}
        out["mask_ratio"] = ratio
        return out


# ---------------------------------------------------------------------------
# Checkpoints: the full train state
# ---------------------------------------------------------------------------

OPT_COUNTS = ("count", "notfinite_count", "last_finite", "total_notfinite")


def save_checkpoint(ckpt_dir: str | Path, trainer: Trainer, epoch: int) -> Path:
    """Write ``ckpt_dir/epoch_%04d.pt`` (through a temporary name and a
    rename, so a run cut while saving leaves no partial ``epoch_*``)."""
    st = trainer.opt_state
    state = {
        "params": {k: p.detach().cpu() for k, p in trainer.params.items()},
        "mu": st.mu_flat.cpu(), "nu": st.nu_flat.cpu(),
        **{k: getattr(st, k).cpu() for k in OPT_COUNTS},
        "step": trainer.step, "epoch": epoch,
    }
    path = Path(ckpt_dir) / f"epoch_{epoch:04d}.pt"
    tmp = path.with_name(f".{path.name}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    cands = sorted(p for p in d.iterdir() if p.name.startswith("epoch_"))
    return cands[-1] if cands else None


def _nest(flat: dict[str, np.ndarray], prefix: str) -> dict:
    """The ``prefix/a/b/leaf`` entries of an exported ``.npz`` as a nested
    dict {a: {b: {leaf: array}}}."""
    tree: dict = {}
    for key, arr in flat.items():
        head, _, path = key.partition("/")
        if head != prefix:
            continue
        *scopes, leaf = path.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = arr
    return tree


def _read_checkpoint(path: str | Path, cfg: Config) -> dict:
    """A ``.pt`` checkpoint, or an exported JAX ``.npz`` converted to the
    same dict: ``params`` (a state_dict), ``mu``/``nu`` (state_dicts), the
    optimizer's counts, ``step`` and ``epoch``."""
    path = Path(path)
    if path.suffix != ".npz":
        return torch.load(path, map_location="cpu", weights_only=True)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    out = {k: state_dict_from_flax(_nest(flat, k), cfg) for k in ("params", "mu", "nu")}
    out.update({k: torch.from_numpy(np.asarray(flat[k])) for k in OPT_COUNTS})
    out.update(step=int(flat["step"]), epoch=int(flat["epoch"]))
    return out


def load_params(path: str | Path, cfg: Config) -> tuple[dict[str, torch.Tensor], int]:
    """(state_dict, epoch) of a ``.pt`` checkpoint or an exported ``.npz``."""
    ck = _read_checkpoint(path, cfg)
    return ck["params"], int(ck["epoch"])


def restore_checkpoint(path: str | Path, trainer: Trainer) -> int:
    """Load a ``.pt`` checkpoint or an exported JAX ``.npz`` into
    ``trainer`` (parameters, optimizer state, step), in place; returns the
    checkpoint's epoch. The moments are laid out in the trainer's
    ``named_parameters`` order."""
    ck = _read_checkpoint(path, trainer.cfg)
    st = trainer.opt_state
    with torch.no_grad():
        for k, p in trainer.params.items():
            p.copy_(ck["params"][k])
        for name, flat in (("mu", st.mu_flat), ("nu", st.nu_flat)):
            m = ck[name]
            flat.copy_(m if isinstance(m, torch.Tensor) else
                       torch.cat([m[k].reshape(-1) for k in trainer.params]))
    for k in OPT_COUNTS:
        setattr(st, k, ck[k].to(device=getattr(st, k).device, dtype=getattr(st, k).dtype))
    trainer.step = int(ck["step"])
    return int(ck["epoch"])

"""Schedule and optimizer (port of ``make_schedule`` / ``make_optimizer``,
lfsr_tpu/train/trainer.py:54-79), written to optax 0.2.6's semantics:

    apply_if_finite(chain(clip_by_global_norm(clip),
                          adamw(warmup_cosine_decay_schedule, weight_decay=wd)),
                    max_consecutive_errors=100)

- schedule: linear warm-up from lr * 0.01 to lr over the warm-up steps,
  then cosine to ``min_lr`` at ``decay_steps`` = all steps;
- clip: when the global norm g_norm is not below ``max_norm``, every
  gradient becomes (g / g_norm) * max_norm (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
- AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction with count + 1, decoupled weight decay on every parameter:
  update = -lr(count) * (m_hat / (sqrt(v_hat) + eps) + wd * p);
- NaN-skip: a step with a non-finite gradient applies no update and leaves
  the inner state (moments and count) as it was, unless more than
  ``max_consecutive_errors`` such steps came in a row.

Everything stays on the parameters' device: the finite test and the
schedule are tensors, and the skip is a ``torch.where``, so a step never
waits for the host. The state keeps optax's fields; optax's
``ScaleByAdamState.count`` and ``ScaleByScheduleState.count`` always move
together, so one ``count`` stands for both. The moments live in two flat
float32 buffers; ``mu``/``nu`` are per-parameter views of them.
Parameters are updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from lfsr_tpu_torch.config import Config

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: count (int or tensor) -> float32
    tensor, in float32 as optax computes it."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).to(torch.float32)
        frac = 1 - torch.clamp(c, 0, warmup_steps) / warmup_steps
        warm = (init_value - peak_value) * frac + peak_value
        t = torch.clamp_max(c - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / cos_steps))
        decay = peak_value * ((1 - alpha) * cosine + alpha)
        return torch.where(c < warmup_steps, warm, decay)

    return schedule


def make_schedule(cfg: Config, steps_per_epoch: int):
    """The reference recipe: min(5, epochs // 10) warm-up epochs (unless
    set), then cosine to ``cfg.min_lr``."""
    warmup_epochs = cfg.warmup_epochs
    if warmup_epochs is None:
        warmup_epochs = min(5, cfg.epochs // 10)
    warmup = max(1, warmup_epochs * steps_per_epoch)
    total = max(warmup + 1, cfg.epochs * steps_per_epoch)
    return warmup_cosine_decay_schedule(cfg.lr * 0.01, cfg.lr, warmup, total, cfg.min_lr)


@dataclass
class OptState:
    """optax's ApplyIfFiniteState around (clip, adamw) state, flattened."""
    mu: dict[str, torch.Tensor]        # first moments (views of mu_flat)
    nu: dict[str, torch.Tensor]        # second moments (views of nu_flat)
    count: torch.Tensor                # int32: accepted updates
    notfinite_count: torch.Tensor      # int32: consecutive non-finite steps
    last_finite: torch.Tensor          # bool: was the last gradient finite
    total_notfinite: torch.Tensor      # int32: non-finite steps in all
    mu_flat: torch.Tensor
    nu_flat: torch.Tensor


def _views(flat: torch.Tensor, named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    sizes = [p.numel() for p in named.values()]
    return {k: v.view(p.shape) for (k, p), v in zip(named.items(), flat.split(sizes))}


class Optimizer:
    """``make_optimizer(cfg, steps_per_epoch)``: init a state for a set of
    named parameters, then :meth:`step_` once per batch."""

    def __init__(self, cfg: Config, steps_per_epoch: int):
        self.schedule = make_schedule(cfg, steps_per_epoch)
        self.max_norm = float(cfg.grad_clip_norm)
        self.weight_decay = float(cfg.weight_decay)

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        p0 = next(iter(params.values()))
        n = sum(p.numel() for p in params.values())
        mu_flat = torch.zeros(n, dtype=torch.float32, device=p0.device)
        nu_flat = torch.zeros_like(mu_flat)
        i32 = dict(dtype=torch.int32, device=p0.device)
        return OptState(
            mu=_views(mu_flat, params), nu=_views(nu_flat, params),
            count=torch.zeros((), **i32), notfinite_count=torch.zeros((), **i32),
            last_finite=torch.ones((), dtype=torch.bool, device=p0.device),
            total_notfinite=torch.zeros((), **i32), mu_flat=mu_flat, nu_flat=nu_flat,
        )

    @torch.no_grad()
    def step_(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
              state: OptState) -> None:
        """One optax update + apply_updates, in place on ``params`` and
        ``state``. ``grads`` has the keys of ``params``."""
        plist = list(params.values())
        p = torch.cat([t.reshape(-1) for t in plist])
        g = torch.cat([grads[k].reshape(-1) for k in params]).to(torch.float32)
        finite = torch.isfinite(g).all()
        notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                state.notfinite_count + 1)
        accept = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)

        g_norm = torch.sqrt((g * g).sum())
        g = torch.where(g_norm < self.max_norm, g, (g / g_norm) * self.max_norm)
        mu = (1 - B1) * g + B1 * state.mu_flat
        nu = (1 - B2) * (g * g) + B2 * state.nu_flat
        count = state.count + 1
        m_hat = mu / (1 - B1 ** count.to(torch.float32))
        v_hat = nu / (1 - B2 ** count.to(torch.float32))
        upd = m_hat / (torch.sqrt(v_hat) + EPS) + self.weight_decay * p
        new_p = p + (-self.schedule(state.count)) * upd

        p = torch.where(accept, new_p, p)
        state.mu_flat.copy_(torch.where(accept, mu, state.mu_flat))
        state.nu_flat.copy_(torch.where(accept, nu, state.nu_flat))
        state.count = torch.where(accept, count, state.count)
        state.total_notfinite = torch.where(finite, state.total_notfinite,
                                            state.total_notfinite + 1)
        state.notfinite_count, state.last_finite = notfinite, finite
        torch._foreach_copy_(plist, [v.view_as(t) for v, t in
                                     zip(p.split([t.numel() for t in plist]), plist)])

"""Model registry of the port (mirrors lfsr_tpu/models/registry.py).

Ported so far: the flagship ``LFMambaX`` (loss ``composite_v8``, whole-scene
eval by default), ``EPIT``, ``LFT`` and ``LF_DET`` (L1, tiled eval), each registered with
its loss builder (``get_loss``). ``get_model`` builds the
module without initialising it (parameters are created on the meta device
and then allocated on ``device``, the card unless the caller asks for the
CPU); fill it with ``bridge.init_params`` or
``bridge.state_dict_from_flax`` through ``load_state_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from lfsr_tpu_torch.config import Config


@dataclass(frozen=True)
class ModelSpec:
    name: str
    cls: Callable
    # loss builder: cfg -> loss_fn(sr, hr) -> scalar
    build_loss: Callable
    # whole-scene (un-tiled) eval is this model's default in the JAX package
    whole_scene_ok: bool = False


_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(name: str, loss: Callable, whole_scene_ok: bool = False):
    def deco(cls):
        _REGISTRY[name] = ModelSpec(name=name, cls=cls, build_loss=loss,
                                    whole_scene_ok=whole_scene_ok)
        return cls

    return deco


def spec(name: str) -> ModelSpec:
    import lfsr_tpu_torch.models.epit  # noqa: F401 — each module registers its model
    import lfsr_tpu_torch.models.lf_det  # noqa: F401
    import lfsr_tpu_torch.models.lfmambax  # noqa: F401
    import lfsr_tpu_torch.models.lft  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"model {name!r} is not ported; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def whole_scene_default(cfg: Config) -> bool:
    """An explicit Config.whole_scene_for_test wins; None defers to the
    model's registry capability (as in the JAX registry)."""
    if cfg.whole_scene_for_test is not None:
        return bool(cfg.whole_scene_for_test)
    return spec(cfg.model_name).whole_scene_ok


def get_model(cfg: Config, device="cuda") -> torch.nn.Module:
    """Uninitialised model on ``device`` (default the card; CPU callers pass
    ``device="cpu"``), in eval mode. Raises when the card is asked for and
    there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_model: no CUDA device; pass device='cpu' to build on the CPU")
    with torch.device("meta"):
        model = spec(cfg.model_name).cls(cfg)
    return model.to_empty(device=device).eval()


def get_loss(cfg: Config) -> Callable:
    """The model's training loss ``loss_fn(sr, hr) -> scalar``."""
    return spec(cfg.model_name).build_loss(cfg)

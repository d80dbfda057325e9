"""Frozen configuration object of the port.

The port's own copy of the JAX package's ``Config`` (``lfsr_tpu/config.py``):
the same fields, defaults, derived properties and methods, so a config
built for one package means the same run in the other.
tests/test_torch_port_config.py holds the two field lists, types and
defaults equal. Configuration is an explicit, immutable value passed to
every constructor.

Derived fields: for the SR task ``angRes_in == angRes_out == angRes``, and
tiled evaluation uses 32-pixel patches with stride 16.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # Task ------------------------------------------------------------------
    task: str = "SR"  # 'SR' (spatial) or 'RE' (angular reconstruction)
    angRes: int = 5   # input angular resolution (angRes_in)
    # RE task only: output angular resolution
    angRes_out_re: Optional[int] = None
    scale_factor: int = 4

    # Model -----------------------------------------------------------------
    model_name: str = "LFMambaX"
    # Per-model keyword overrides (channels, depth, ...), read with
    # ``cfg.mk(key, default)``.
    model_kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    # Data ------------------------------------------------------------------
    data_name: str = "ALL"
    path_for_train: str = "./data_for_train/"
    path_for_test: str = "./data_for_test/"
    path_log: str = "./log/"
    patch_size_for_train: int = 32  # LR patch edge per view during training

    # Optimization ------------------------------------------------------------
    batch_size: int = 4
    lr: float = 2e-4
    weight_decay: float = 1e-4
    epochs: int = 51
    # None derives min(5, epochs // 10).
    warmup_epochs: Optional[int] = None
    eval_every: int = 5  # validation cadence in epochs
    min_lr: float = 1e-6
    grad_clip_norm: float = 1.0
    compute_dtype: str = "bfloat16"  # activations; params stay float32
    seed: int = 0
    # In-step flip/transpose augmentation; off for deterministic parity
    # harnesses.
    augment: bool = True

    # Masked angular pre-training ---------------------------------------------
    use_masked_pretrain: bool = True
    mask_start_ratio: float = 0.1
    mask_end_ratio: float = 0.3
    mask_warmup_epochs: int = 20
    mask_strategy: str = "random"

    # Tiled evaluation ----------------------------------------------------------
    patch_size_for_test: int = 32
    stride_for_test: int = 16
    minibatch_for_test: int = 2  # patches per device step
    # Process each scene as ONE un-tiled SAI mosaic instead of the
    # overlapping 32/16 patch grid. None = auto: defer to the model
    # registry's per-model capability (registry.whole_scene_default);
    # True/False forces the mode.
    whole_scene_for_test: Optional[bool] = None
    # Mirror-extend each view by this many LR pixels before an un-tiled
    # call (cropped back after).
    whole_scene_pad: int = 8
    # scenes per whole-scene dispatch (separate from the tiled patch
    # minibatch)
    whole_scene_minibatch: int = 4
    # EPSW: blend overlapping SR patches with a Gaussian weight centred on
    # each patch instead of the hard center crop (tiled eval only).
    # epsw_sigma is in SR pixels; None = input_patch / 6.
    epsw_for_test: bool = False
    epsw_sigma: Optional[float] = None

    # Parallelism -------------------------------------------------------------
    mesh_shape: Optional[Tuple[int, ...]] = None  # None => all local devices
    mesh_axis_names: Tuple[str, ...] = ("data",)

    # Derived ----------------------------------------------------------------
    @property
    def angRes_in(self) -> int:
        return self.angRes

    @property
    def angRes_out(self) -> int:
        if self.task == "RE" and self.angRes_out_re:
            return self.angRes_out_re
        return self.angRes

    def mk(self, key: str, default: Any) -> Any:
        """Look up a per-model hyperparameter override."""
        return self.model_kwargs.get(key, default)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def task_tag(self) -> str:
        """Directory tag, e.g. 'SR_5x5_4x' or 'RE_2x2_5x5'."""
        if self.task == "RE":
            return (
                f"RE_{self.angRes}x{self.angRes}_"
                f"{self.angRes_out}x{self.angRes_out}"
            )
        return f"{self.task}_{self.angRes}x{self.angRes}_{self.scale_factor}x"

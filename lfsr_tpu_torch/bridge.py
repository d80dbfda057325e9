"""Parameters for the port: flax param tree -> ``state_dict``, and a seeded
random initialisation.

The port's modules carry the flax scope names (``block_3.CrossScanSSM_0.
mamba``), so a flax leaf ``a/b/kernel`` maps to ``a.b.weight`` with a layout
change:

- conv kernels HWIO [kh, kw, I/g, O] (depthwise [K, K, 1, C] included)
  -> torch OIHW [O, I/g, kh, kw];
- Dense kernels [in, out] -> nn.Linear weight [out, in];
- LayerNorm ``scale`` -> ``weight``;
- Mamba: ``{in,x,dt,out}_proj_kernel`` -> ``*.weight`` (transposed),
  ``conv1d_kernel`` [K, 1, Di] -> Conv1d weight [Di, 1, K],
  ``conv1d_bias``/``dt_proj_bias`` -> ``*.bias``; ``A_log`` and ``D`` as is;
- scalar and table params (``scale``, ``res_scale``, ``attn_scale``,
  ``out_scale``, ``stage_weights``, ``rel_pos_table``) as is.

The IFE's 5x5 and 7x7 kernels stay the two flax leaves ``Conv_2`` and
``Conv_4`` (the JAX module merges them only at apply time).
:func:`state_dict_from_flax` raises on any flax leaf it does not use and on
any port parameter it does not fill.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models.common import LayerNorm
from lfsr_tpu_torch.models.registry import get_model

_MAMBA = {
    "in_proj_kernel": ("in_proj.weight", lambda a: a.T),
    "conv1d_kernel": ("conv1d.weight", lambda a: a.transpose(2, 1, 0)),
    "conv1d_bias": ("conv1d.bias", lambda a: a),
    "x_proj_kernel": ("x_proj.weight", lambda a: a.T),
    "dt_proj_kernel": ("dt_proj.weight", lambda a: a.T),
    "dt_proj_bias": ("dt_proj.bias", lambda a: a),
    "out_proj_kernel": ("out_proj.weight", lambda a: a.T),
    "A_log": ("A_log", lambda a: a),
    "D": ("D", lambda a: a),
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert(path: tuple[str, ...], arr: np.ndarray):
    """One flax leaf -> (torch key, array in torch layout)."""
    *scope, leaf = path
    parent = ".".join(scope)
    if scope and scope[-1] == "mamba" and leaf in _MAMBA:
        name, fn = _MAMBA[leaf]
        return f"{parent}.{name}", fn(arr)
    if leaf == "kernel" and arr.ndim == 4:
        return f"{parent}.weight", arr.transpose(3, 2, 0, 1)
    if leaf == "kernel" and arr.ndim == 2:
        return f"{parent}.weight", arr.T
    if leaf == "scale" and scope and scope[-1].startswith("LayerNorm"):
        return f"{parent}.weight", arr
    return ".".join(path), arr


def state_dict_from_flax(params, cfg: Config) -> dict[str, torch.Tensor]:
    """Convert a flax param tree (nested dicts of arrays, with or without
    the top-level ``params`` key) for ``cfg``'s model into a state_dict."""
    if "params" in params:
        params = params["params"]
    want = {k: tuple(v.shape) for k, v in get_model(cfg, device="meta").state_dict().items()}
    out, unused = {}, []
    for path, leaf in _flatten(params):
        key, arr = _convert(path, np.asarray(leaf, dtype=np.float32))
        if key not in want:
            unused.append("/".join(path))
            continue
        if tuple(arr.shape) != want[key]:
            raise ValueError(f"{'/'.join(path)} -> {key}: shape {arr.shape} != {want[key]}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    if unused:
        raise ValueError(f"flax leaves not used by the port: {unused}")
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"port parameters not filled from the flax tree: {missing}")
    return out


def _lecun_normal_(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """flax lecun_normal: truncated normal (+-2 sd), variance 1/fan_in."""
    fan_in = math.prod(t.shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


def init_params(cfg: Config, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random state_dict with flax's initialisers for every parameter
    (lecun-normal kernels, zero biases, unit LayerNorm scales, the Mamba
    A_log/D init and the constants the model class lists in its
    ``init_constants()``), drawn from ``generator`` on the CPU."""
    model = get_model(cfg, device="meta")
    modules = dict(model.named_modules())
    consts = model.init_constants()
    out = {}
    for key, p in model.state_dict().items():
        t = torch.empty(p.shape, dtype=torch.float32)
        owner, _, leaf = key.rpartition(".")
        if key in consts:
            t.fill_(consts[key])
        elif isinstance(modules[owner], LayerNorm):
            t.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "A_log":
            t.copy_(torch.log(torch.arange(1, p.shape[1] + 1, dtype=torch.float32)).expand_as(t))
        elif leaf == "D":
            t.fill_(1.0)
        elif leaf == "rel_pos_table":
            torch.nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=generator)
        elif leaf == "bias":
            t.zero_()
        elif leaf == "weight":
            _lecun_normal_(t, generator)
        else:
            raise KeyError(f"no initialiser for {key}")
        out[key] = t
    return out


def param_count(state_dict: dict[str, torch.Tensor]) -> int:
    return sum(t.numel() for t in state_dict.values())

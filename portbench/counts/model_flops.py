"""Model FLOPs of a cell's units, counted by ``FlopCounterMode`` over the
plain reference (``reference/``) on the meta device at the shapes the
program runs: matrix products and convolutions, forward (and backward in
training); elementwise work and FFTs are not counted."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import common
from portbench.reference import train as ref_train


def _meta_params(loop, grad: bool) -> dict:
    specs = loop.ref.param_specs(loop.kw, loop.cfg.angRes, loop.cfg.scale_factor)
    return {k: torch.empty(s, device="meta", requires_grad=grad) for k, (s, _) in specs.items()}


def forward_flops(loop, shape: tuple) -> float:
    """FLOPs of one forward of the reference on x of ``shape`` [B, H, W, 1]."""
    p = _meta_params(loop, False)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        loop.ref.forward(p, torch.empty(shape, device="meta"), loop.kw, loop.cfg.angRes,
                         loop.cfg.scale_factor)
    return float(fc.get_total_flops())


def step_flops(loop) -> float:
    """FLOPs of one train step: forward, loss and the backward."""
    cfg, t = loop.cfg, loop.cell.traffic
    side = t["hr_view"] // cfg.scale_factor * cfg.angRes
    p = _meta_params(loop, True)
    x = torch.empty((cfg.batch_size, side, side, 1), device="meta")
    y = torch.empty((cfg.batch_size, side * cfg.scale_factor, side * cfg.scale_factor, 1),
                    device="meta")
    with FlopCounterMode(display=False) as fc:
        sr = loop.ref.forward(p, x, loop.kw, cfg.angRes, cfg.scale_factor)
        loss = ref_train.LOSSES[loop.cell.config["loss"]](sr, y)
        torch.autograd.grad(loss, list(p.values()))
    return float(fc.get_total_flops())


def per_scene(loop) -> dict:
    """subset -> FLOPs of one scene, by the cell's protocol."""
    cfg, out = loop.cfg, {}
    ang = cfg.angRes
    for g in loop.cell.traffic["geometries"]:
        h0, w0 = (side // cfg.scale_factor for side in g["hr"])
        if loop.whole:
            x, _ = common.whole_pad(torch.empty(ang * h0, ang * w0, device="meta"), ang,
                                    cfg.whole_scene_pad)
            out[g["subset"]] = forward_flops(loop, (1, *x.shape, 1))
        else:
            n1, n2 = common.tile_grid(h0, w0, cfg.patch_size_for_test, cfg.stride_for_test)
            mb = cfg.minibatch_for_test
            side = ang * cfg.patch_size_for_test
            calls = -(-n1 * n2 // mb)
            out[g["subset"]] = calls * forward_flops(loop, (mb, side, side, 1))
    return out


def window_flops(loop, win: dict) -> float:
    kind = loop.cell.traffic["loop"]
    if kind == "scenes":
        flops = per_scene(loop)
        return sum(n * flops[k] for k, n in win["by_subset"].items())
    if kind == "train":
        return win["units"] * step_flops(loop)
    raise KeyError(kind)

"""The benchmark's seeded weights, made on the device.

The initialisers are those the models are trained from (a frozen copy of
the scheme: truncated lecun-normal kernels, zero biases, unit LayerNorm
scales, Mamba's A_log and D, the Swin table's sd 0.02, the constants each
model lists), applied to the reference's own parameter list. All random
leaves come from one truncated-normal call on the device, scaled leaf by
leaf, so set-up makes them in one large call. The same dict is loaded into
the program's model and read by the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.seeds import stream_seed
from portbench.reference.common import lecun_std


def make_weights(specs: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``specs`` (name -> (shape, init), a reference's ``param_specs``) ->
    float32 tensors on ``device``."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "weights"))
    drawn = [n for n, (_, init) in specs.items() if init in ("lecun", "rel_pos")]
    total = sum(math.prod(specs[n][0]) for n in drawn)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=g)
    out, off = {}, 0
    for name, (shape, init) in specs.items():
        n = math.prod(shape)
        if init in ("lecun", "rel_pos"):
            sd = lecun_std(shape) if init == "lecun" else 0.02
            t = buf[off : off + n].view(shape) * sd
            off += n
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "ones":
            t = torch.ones(shape, device=device)
        elif init == "A_log":
            t = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device))
            t = t.expand(shape).contiguous()
        elif isinstance(init, float):
            t = torch.full(shape, init, device=device)
        else:
            raise KeyError(f"no initialiser {init!r} for {name}")
        out[name] = t
    return out


def param_count(weights: dict) -> int:
    return sum(t.numel() for t in weights.values())

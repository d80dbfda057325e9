"""Track-2 efficiency gate: parameters, official MACs, latency, memory.

The port of ``lfsr_tpu/tools/efficiency.py``; the report has its keys:
- constraints: < 1,000,000 parameters and < 20 G MACs at the official SAI
  input [1, 1, 160, 160] (NHWC [1, 160, 160, 1]);
- the parameter count with a per-module breakdown under the flax scope
  names the port's modules carry (``block_3``, ``HLFR_0``, ...);
- ``official_fvcore_macs`` and ``flops_breakdown``: the count the JAX
  package's ``fvcore_macs_detailed`` gives on the CPU, module by module
  (:func:`official_macs`);
- ``xla_flops``, ``flops_mac_convention`` and ``flops_pass`` are None: the
  port has no XLA cost analysis (``format_report`` leaves that line out);
- with ``bench=True``: latency on the card (CUDA events, warm-up, then
  timed calls) and ``torch.cuda`` memory statistics.

The official count is taken from the model's function, not from what
launched, so it is the same on the CPU and on the card: the model runs
once on the meta device with every kernel wrapper on its plain twin
(nothing is computed or launched), under ``FlopCounterMode``, which counts
each top-level module's convs and matmuls (1 MAC per multiply-add,
fvcore's convention; elementwise ops, norms and the scan's recurrence are
skipped, as fvcore skips them). To that come the products JAX's CPU jaxpr
holds and the twins do not run (``_JAX_ONLY``):
- the probes the JAX modules apply to read a kernel: ``_mix_kernel`` and
  ``_pw_apply`` apply a 1x1 conv to a [1, 1, 1, C_in] probe, ``_dw_apply``
  a depthwise conv to a [1, p, p, C] probe (p = dilation * (k - 1) + 1),
  the IFE its 5x5 and 7x7 convs to [1, 8, 8, 1] probes and the HLFR its
  out-conv to a [1, 4, 4, C] probe; JAX's walker counts these too;
- where JAX and the twin compute the same thing by other products: the
  IFE's 5x5 and 7x7 convs, which JAX runs as one 2-channel 7x7 conv; the
  Mamba's causal depthwise conv1d, which the twin runs as shifted
  multiply-adds; the bicubic residual, which JAX runs as two dense
  matmuls (``_bicubic``);
- on the CPU JAX runs the window attention as its Pallas kernel in
  interpret mode, and its walker counts the body of a ``pallas_call``
  once, not once per grid step (fault F4 of the reference, ROADMAP.md):
  :func:`_window_attention` counts one grid step, as JAX does, in place of
  the twin's products. The count mirrors the reference's CPU number, F4
  included.
"""

from __future__ import annotations

import torch

from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.models import lfmambax as lm
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.ops import _cuda

PARAM_LIMIT = 1_000_000
FLOPS_LIMIT = 20e9  # MAC convention, matching fvcore / the challenge gate
OFFICIAL_INPUT = (1, 160, 160, 1)  # NHWC of the official [1,1,160,160]


def count_params(state_dict: dict[str, torch.Tensor]) -> tuple[int, dict[str, int]]:
    """Total parameters and their sum per top-level module (the first
    component of each name; the port's names are the flax scopes)."""
    by_module: dict[str, int] = {}
    for key, t in state_dict.items():
        top = key.split(".")[0]
        by_module[top] = by_module.get(top, 0) + t.numel()
    return sum(by_module.values()), by_module


# ---------------------------------------------------------------------------
# the official MACs of LFMambaX, module by module
# ---------------------------------------------------------------------------

def _dw_probe(c: int, k: int = 3, d: int = 1) -> int:
    """``_dw_apply``'s probe: a depthwise k x k conv on [1, p, p, c], 'same'."""
    p = d * (k - 1) + 1
    return p * p * c * k * k


def _ife(m, x) -> int:
    """The 5x5 and 7x7 probes and Conv_5's and Conv_6's; the 5x5 and 7x7
    convs as one 2-channel 7x7 conv (98 MACs a pixel, the twin's 25 + 49)."""
    B, H, W, _ = x.shape
    C = m.Conv_5.weight.shape[0]
    return 8 * 8 * 25 + 8 * 8 * 49 + C * C + _dw_probe(C) + B * H * W * (2 * 49 - 25 - 49)


def _block(m, x) -> int:
    """The local branch's three probes and the fuse's two; the causal
    depthwise conv1d."""
    B, H, W, C = x.shape
    c4, conv1d = m.MultiScaleLocal_0.c, m.CrossScanSSM_0.mamba.conv1d
    Di, K = conv1d.weight.shape[0], conv1d.weight.shape[-1]
    return _dw_probe(C - c4) + c4 * c4 + C * C + 2 * C * C + B * H * W * Di * K


def _spatial_attention(m, x) -> int:
    C = x.shape[-1]
    return _dw_probe(C) + _dw_probe(C, d=3) + 5 * C * C  # Conv_2, Conv_3, Conv_4: 2 + 1 + 2


def _lsfl(m, x) -> int:
    C = x.shape[-1]
    return 6 * C * C + _dw_probe(C)  # Conv_1, Conv_3: 1 each; Conv_4, Conv_6: 2 each


def _progressive_fusion(m, blocks) -> int:
    C = blocks[0].shape[-1]
    return 4 * m.ns * C * C + _dw_probe(C)  # proj_s*: 3 each; Conv_0: ns; Conv_1


def _hlfr(m, x) -> int:
    """Three branches' depthwise and 1x1 probes, the edge's depthwise and
    two 1x1 probes, each stage's depthwise and expansion probes, and the
    out-conv's."""
    C = x.shape[-1]
    c8 = m.Conv_7.weight.shape[0]
    n = 3 * (_dw_probe(C) + C * C) + _dw_probe(C) + 2 * C * c8 + 16 * C * 9
    return n + sum(_dw_probe(C) + C * C * r * r for r in m.stages)


_JAX_ONLY = {lm.IFE: _ife, lm.LFVSSMBlock: _block, lm.SpatialAttention: _spatial_attention,
             lm.LSFL: _lsfl, lm.ProgressiveFusion: _progressive_fusion, lm.HLFR: _hlfr}


def _window_attention(m, x) -> int:
    """The two Dense probes and ONE grid step of JAX's ``_win_mha_raw``
    (F4): R window rows of W / ws windows (R = 2 when W <= 320 and the rows
    pair up, else 1), each T = ws^2 tokens: qkv, the block-diagonal scores
    and values over heads * T columns, the out-projection."""
    _, H, W, C = x.shape
    ws, heads = m.window, m.heads
    T, nrows = ws * ws, H // ws
    rpb = 1 if W > 320 else 2
    R = rpb if nrows % rpb == 0 else 1
    rows = R * (W // ws) * T
    return 3 * C * C + C * C + rows * C * 3 * C + 2 * rows * heads * T * C + rows * C * C


def _bicubic(x_shape, s: int) -> int:
    """JAX's dense-plan bicubic residual: one matmul along H, one along W."""
    B, H, W, _ = x_shape
    return B * W * H * (H * s) + B * (H * s) * W * (W * s)


def _meta_forward(model, input_shape):
    """The model on the meta device, every kernel wrapper on its plain
    twin: its output shape, and the first positional input and the conv /
    matmul MACs (``FlopCounterMode``'s flops / 2) of each top-level module,
    the ops outside them under "(top)"."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    inputs: dict[str, torch.Tensor] = {}
    macs: dict[str, int] = {}

    def pre(name, args):
        inputs[name] = args[0]
        macs[name] = -counter.get_total_flops()

    def post(name):
        macs[name] = (macs[name] + counter.get_total_flops()) // 2

    hooks = []
    for name, mod in model.named_children():
        hooks.append(mod.register_forward_pre_hook(lambda _m, a, n=name: pre(n, a)))
        hooks.append(mod.register_forward_hook(lambda _m, _a, _y, n=name: post(n)))
    try:
        with torch.no_grad(), _cuda.force_plain(), counter:
            y = model(torch.zeros(input_shape, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    macs["(top)"] = counter.get_total_flops() // 2 - sum(macs.values())
    return tuple(y.shape), inputs, macs


def official_macs(cfg: Config, input_shape=OFFICIAL_INPUT):
    """(total, per-module MACs, output shape) of ``cfg``'s model at
    ``input_shape``, JAX's CPU count module by module (module docstring)."""
    if cfg.model_name != "LFMambaX":
        raise NotImplementedError(
            f"official MAC count: ported for LFMambaX only, not {cfg.model_name!r} "
            f"(ROADMAP.md section 1)")
    model = get_model(cfg, device="meta")
    out_shape, inputs, macs = _meta_forward(model, input_shape)
    by_module = {"(top)": macs["(top)"] + _bicubic(input_shape, cfg.scale_factor)}
    for name, mod in model.named_children():
        if isinstance(mod, lm.WindowAttention):
            by_module[name] = _window_attention(mod, inputs[name])
        else:
            by_module[name] = macs[name] + _JAX_ONLY[type(mod)](mod, inputs[name])
    return sum(by_module.values()), by_module, out_shape


# ---------------------------------------------------------------------------
# latency and memory on the card
# ---------------------------------------------------------------------------

def latency_bench(model, x, warmup=5, iters=50) -> dict:
    """Queued throughput and per-call latency on the card, by CUDA events.

    ``throughput_ms`` queues ``iters`` calls between two events;
    ``latency_ms`` synchronises after every call (single-dispatch latency).
    """
    with torch.inference_mode():
        for _ in range(warmup):
            model(x)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x)
        stop.record()
        torch.cuda.synchronize()
        queued = start.elapsed_time(stop) / iters
        total = 0.0
        for _ in range(iters):
            start.record()
            model(x)
            stop.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(stop)
    synced = total / iters
    return {"throughput_ms": queued, "latency_ms": synced, "throughput_per_s": 1e3 / queued}


def memory_stats(device) -> dict:
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}


def check_efficiency(cfg: Config, bench: bool = False, input_shape=OFFICIAL_INPUT,
                     device="cuda") -> dict:
    """The gate's report for ``cfg``'s model (keys of the JAX report).
    Counting runs on the meta device; ``bench`` times the model, from the
    seeded init, on ``device``, which must be the card. Without a card the
    call raises unless ``device="cpu"`` (and then ``bench`` is refused)."""
    from lfsr_tpu_torch.bridge import init_params

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("check_efficiency: no CUDA device; pass device='cpu' to count on the CPU")
    if bench and device.type != "cuda":
        raise ValueError("check_efficiency: bench times the card; device must be 'cuda'")
    sd = get_model(cfg, device="meta").state_dict()
    total, breakdown = count_params(sd)
    official, flops_breakdown, out_shape = official_macs(cfg, input_shape)
    report = {
        "model": cfg.model_name,
        "input_shape": list(input_shape),
        "params": total,
        "non_trainable": {},
        "params_limit": PARAM_LIMIT,
        "params_pass": total < PARAM_LIMIT,
        "param_breakdown": dict(sorted(breakdown.items(), key=lambda kv: -kv[1])),
        "xla_flops": None,
        "flops_mac_convention": None,
        "official_fvcore_macs": official,
        "flops_breakdown": dict(sorted(flops_breakdown.items(), key=lambda kv: -kv[1])),
        "official_pass": official < FLOPS_LIMIT,
        "flops_limit": FLOPS_LIMIT,
        "flops_pass": None,
    }
    s = cfg.scale_factor
    report["output_shape_pass"] = out_shape == (
        input_shape[0], input_shape[1] * s, input_shape[2] * s, input_shape[3],
    )
    if bench:
        model = get_model(cfg, device=device)
        model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
        torch.cuda.reset_peak_memory_stats(device)
        report["latency"] = latency_bench(model, torch.zeros(input_shape, device=device))
        report["memory"] = memory_stats(device)
    report["verdict"] = bool(
        report["params_pass"] and report["official_pass"] and report["output_shape_pass"]
    )
    return report


def format_report(r: dict, detailed: bool = False) -> str:
    lines = [
        f"model: {r['model']}  input {r['input_shape']}",
        f"params: {r['params']:,} / {r['params_limit']:,}  "
        f"[{'PASS' if r['params_pass'] else 'FAIL'}]",
    ]
    if detailed:
        lines.append("per-module breakdown (params | official MACs):")
        flops = r.get("flops_breakdown", {})
        mods = dict(r.get("param_breakdown", {}))
        for name in sorted(set(mods) | set(flops),
                           key=lambda n: -flops.get(n, 0)):
            lines.append(
                f"  {name:<28s} {mods.get(name, 0):>10,}  "
                f"{flops.get(name, 0) / 1e9:>8.3f} G"
            )
    if r["flops_mac_convention"] is not None:
        lines.append(
            f"flops (MAC conv.): {r['flops_mac_convention']/1e9:.2f} G / "
            f"{r['flops_limit']/1e9:.0f} G  [{'PASS' if r['flops_pass'] else 'FAIL'}]"
            f"   (xla raw: {r['xla_flops']/1e9:.2f} G)"
        )
    lines.append(
        f"flops (official fvcore conv.): {r['official_fvcore_macs']/1e9:.2f} G / "
        f"{r['flops_limit']/1e9:.0f} G  [{'PASS' if r['official_pass'] else 'FAIL'}]"
    )
    lines.append(f"output shape: [{'PASS' if r['output_shape_pass'] else 'FAIL'}]")
    if "latency" in r:
        lines.append(
            f"latency: {r['latency']['latency_ms']:.2f} ms/call  "
            f"queued: {r['latency']['throughput_ms']:.2f} ms  "
            f"({r['latency']['throughput_per_s']:.1f} patches/s)"
        )
    lines.append(f"VERDICT: {'PASS' if r['verdict'] else 'FAIL'}")
    return "\n".join(lines)

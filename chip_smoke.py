#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lfsr_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check (one card)
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only
    python3 chip_smoke.py --profile       # + a torch.profiler trace of one dispatch

Phases (any failure exits non-zero):
1. Card and build: print ``nvidia-smi`` name and power limit; build the
   Hopper kernels from ``lfsr_tpu_torch/csrc`` with nvcc (timed).
2. Kernels vs plain: each kernel (K1 scan, K4 cross-scan gather, K5
   cross-scan scatter, K6 window attention) against its plain PyTorch twin
   on the card at the tiled-eval shapes, in float32 with TF32 off (tight
   bound) and in bfloat16 (loose bound), with kernel and twin times.
3. The slice: the full-width flagship LFMambaX (64 channels, 12 blocks,
   d_state 16, bf16 activations) from a seeded random init, tiled
   ``evaluate_sets`` over two synthetic seeded 5x5 scenes (128^2 LR, 512^2
   HR per view). Checks the kernel launch counts of the run, finite SR
   views, agreement with the same run on the plain twins, finite
   PSNR/SSIM; prints them beside the bicubic baseline, with ms/scene.
4. Prints the kernels' JSON line, then the final result line.

Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CARD = "unknown card"
DEVICE = "cuda"  # the script runs on the card; only a CPU rehearsal changes it

# max|kernel - twin| <= bound * max(1, max|twin|)
F32_BOUND = 1e-4
BF16_BOUND = 3e-2
# kernel-path vs plain-path SR views of the full bf16 model (values in ~[0, 1])
SR_BOUND = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_inputs(dtype, g: torch.Generator):
    """Operands of the four kernels at the tiled-eval shapes: minibatch 2 of
    160x160 SAI patches, 64 channels, Di 80, d_state 16, dt rank 4."""
    dev = DEVICE

    def rn(*shape, s=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=g) * s).to(dev, dt)

    B, S, C, Di, N, R = 2, 160, 64, 80, 16, 4
    L = S * S
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(Di, 1).to(dev)
    k1 = (rn(B, L, Di, s=0.5, dt=dtype), rn(B, L, R + 2 * N, s=0.5, dt=dtype),
          rn(R, Di, s=0.3), rn(Di, s=0.1), A, torch.ones(Di, device=dev))
    k4 = (rn(B, S, S, C, dt=dtype), 1 + rn(C, s=0.2), rn(C, s=0.1))
    k5 = (rn(B, L, C, dt=dtype), rn(B, S, S, C, dt=dtype), rn(C, C, s=0.125, dt=dtype),
          torch.full((1,), 0.15, device=dev))
    T, heads = 64, 4
    k6 = (rn(B, S, S, C, dt=dtype), rn(C, 3 * C, s=0.125), rn(C, C, s=0.125),
          1 + rn(C, s=0.2), rn(C, s=0.1), rn(T, heads * T, s=0.02),
          torch.full((1,), 0.25, device=dev))
    return {"K1": k1, "K4": k4, "K5": k5, "K6": k6}


def check_kernels(results: dict) -> None:
    from lfsr_tpu_torch.ops import cross_scan as cs
    from lfsr_tpu_torch.ops import scan, window_attention as wa

    pairs = {
        "K1": (scan.selective_scan_proj, scan.selective_scan_proj_plain),
        "K4": (cs.cross_scan_gather, cs.cross_scan_gather_plain),
        "K5": (cs.cross_scan_scatter, cs.cross_scan_scatter_plain),
        "K6": (wa.window_mha_fused, wa.window_mha_plain),
    }
    # the dtype each kernel sees on the flagship's bf16 path: K6 runs on the
    # float32 residual stream
    main_dtype = {"K1": torch.bfloat16, "K4": torch.bfloat16, "K5": torch.bfloat16,
                  "K6": torch.float32}
    g = torch.Generator().manual_seed(SEED)
    for dtype, bound in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
        inputs = kernel_inputs(dtype, g)
        for name, (kern, plain) in pairs.items():
            args = inputs[name]
            got = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            ok = bool(np.isfinite(err)) and err <= bound * scale
            ms = time_ms(lambda: kern(*args))
            plain_ms = time_ms(lambda: plain(*args), iters=5, warmup=1)
            log(f"[kernels] {name} {str(dtype)[6:]:8s} shape {tuple(args[0].shape)} "
                f"max|d|={err:.3e} bound={bound * scale:.3e} {'ok' if ok else 'FAIL'} | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({CARD})")
            if not ok:
                raise AssertionError(f"{name} {dtype}: max|d| {err} > {bound * scale}")
            if dtype == main_dtype[name]:
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def make_scene(rng: np.random.Generator, name: str, ang: int = 5, hr: int = 512,
               scale: int = 4):
    """Synthetic 5x5 light field: a smooth random texture, shifted per view
    by a disparity; LR is a scale x scale box downsample of each view."""
    from lfsr_tpu_torch.data.datasets import TestScene

    pad = 16
    yy, xx = np.mgrid[0 : hr + 2 * pad, 0 : hr + 2 * pad].astype(np.float64)
    tex = np.zeros_like(yy)
    for _ in range(6):
        fy, fx = rng.uniform(0.005, 0.05, 2)
        ph = rng.uniform(0, 2 * np.pi)
        tex += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    disp = rng.uniform(0.5, 1.5)
    views = np.empty((ang, ang, hr, hr), np.float32)
    for u in range(ang):
        for v in range(ang):
            dy = int(round(disp * (u - ang // 2)))
            dx = int(round(disp * (v - ang // 2)))
            views[u, v] = tex[pad + dy : pad + dy + hr, pad + dx : pad + dx + hr]
    lr = views.reshape(ang, ang, hr // scale, scale, hr // scale, scale).mean(axis=(3, 5))
    to_sai = lambda a: a.transpose(0, 2, 1, 3).reshape(ang * a.shape[2], ang * a.shape[3])
    return TestScene(
        name=name, dataset="Synthetic", lr_y=to_sai(lr).astype(np.float32),
        hr_y=to_sai(views), sr_cbcr=np.zeros((ang * hr, ang * hr, 2), np.float32),
    )


def bicubic_baseline(scene, ang: int, s: int):
    from lfsr_tpu_torch.ops.layout import sai_to_views, views_to_sai
    from lfsr_tpu_torch.ops.metrics import lf_metrics

    lr = sai_to_views(torch.as_tensor(scene.lr_y, device=DEVICE), ang)
    up = torch.nn.functional.interpolate(
        lr.reshape(ang * ang, 1, *lr.shape[-2:]), scale_factor=s, mode="bicubic",
        align_corners=False,
    ).reshape(ang, ang, lr.shape[-2] * s, lr.shape[-1] * s)
    p, ss = lf_metrics(torch.as_tensor(scene.hr_y, device=DEVICE), views_to_sai(up), ang)
    return float(p), float(ss)


def profile_dispatch(model, scene, cfg, reps: int = 3) -> None:
    """One tiled-eval dispatch (a minibatch of SAI patches) under
    torch.profiler: device time by kernel and the device's idle share (one
    minus the union of kernel intervals over the host wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lfsr_tpu_torch.ops.tiling import lf_divide

    lr = torch.as_tensor(scene.lr_y, device=DEVICE)
    x = lf_divide(lr, cfg.angRes, cfg.patch_size_for_test, cfg.stride_for_test)
    x = x[: cfg.minibatch_for_test, ..., None].contiguous()
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side kernel events only: the host ops' rows repeat their kernels' time
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    log(f"[profile] one dispatch ({cfg.minibatch_for_test} patches): wall "
        f"{wall_us / reps / 1e3:.2f} ms, device busy {busy_us / reps / 1e3:.2f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}, {len(kernels) // reps} kernel launches, "
        f"{len(rows)} kernel names ({CARD})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile]   {e.self_device_time_total / reps / 1e3:8.3f} ms "
            f"{e.count // reps:5d}x  {e.key[:90]}")


def run_slice(results: dict, profile: bool = False) -> dict:
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.bridge import init_params, param_count
    from lfsr_tpu_torch.models.registry import get_model
    from lfsr_tpu_torch.ops import KERNELS, _cuda, launch_counts, reset_launch_counts
    from lfsr_tpu_torch.ops.tiling import tile_counts
    from lfsr_tpu_torch.train.evaluate import evaluate_scene, evaluate_sets

    cfg = Config(whole_scene_for_test=False)
    sd = init_params(cfg, torch.Generator().manual_seed(SEED))
    n_params = param_count(sd)
    assert n_params == 693_998, n_params
    model = get_model(cfg, device=DEVICE)
    model.load_state_dict(sd)
    rng = np.random.default_rng(SEED)
    scenes = [make_scene(rng, f"scene{i}") for i in range(2)]
    ang, s = cfg.angRes, cfg.scale_factor
    h0 = scenes[0].lr_y.shape[0] // ang
    n1, n2 = tile_counts(h0, h0, cfg.patch_size_for_test, cfg.stride_for_test)
    dispatches = -(-n1 * n2 // cfg.minibatch_for_test)
    log(f"[slice] LFMambaX {n_params} params, {cfg.compute_dtype}, 2 scenes, "
        f"{n1 * n2} patches/scene, {dispatches} dispatches of {cfg.minibatch_for_test}")

    evaluate_scene(model, scenes[0], cfg)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    if profile:
        profile_dispatch(model, scenes[0], cfg)

    reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate_sets(model, {"Synthetic": scenes}, cfg, log=log, keep_views=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    per_forward = {"K1 selective_scan_proj": 12, "K4 cross_scan_gather": 12,
                   "K5 cross_scan_scatter": 12, "K6 window_mha_fused": 2}
    for name, n in per_forward.items():
        want = n * dispatches * len(scenes)
        assert counts[name] == want, f"{name}: {counts[name]} launches, expected {want}"
    log(f"[slice] launches {counts} = {dispatches} dispatches x (12, 12, 12, 2) x 2 scenes")

    views = res["Synthetic"]["views"]
    for sc in scenes:
        v = views[sc.name]
        assert tuple(v.shape) == (ang, ang, h0 * s, h0 * s), v.shape
        assert torch.isfinite(v).all(), f"{sc.name}: non-finite SR"
    for name, p, ss in res["Synthetic"]["scenes"]:
        assert np.isfinite(p) and np.isfinite(ss), (name, p, ss)

    with _cuda.force_plain():
        res_plain = evaluate_sets(model, {"Synthetic": scenes}, cfg, log=lambda m: None,
                                  keep_views=True)
    sr_err = max((views[k] - res_plain["Synthetic"]["views"][k]).abs().max().item()
                 for k in views)
    log(f"[slice] kernels vs plain twins: max|d SR| = {sr_err:.3e} (bound {SR_BOUND}); "
        f"PSNR {res['Synthetic']['psnr']:.4f} vs {res_plain['Synthetic']['psnr']:.4f} dB")
    assert sr_err <= SR_BOUND, sr_err

    base = [bicubic_baseline(sc, ang, s) for sc in scenes]
    log(f"[slice] PSNR/SSIM {res['Synthetic']['psnr']:.4f}/{res['Synthetic']['ssim']:.4f} "
        f"(random init) | bicubic {np.mean([b[0] for b in base]):.4f}/"
        f"{np.mean([b[1] for b in base]):.4f}")
    log(f"[slice] {1e3 * seconds / len(scenes):.1f} ms/scene, "
        f"{len(scenes) / seconds:.4f} scenes/s, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD})")
    return {name: counts[name] for name in KERNELS}


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, shared memory, spills)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one dispatch with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lfsr_tpu_torch.ops import KERNELS, _cuda

    CARD = card_info()
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off")
    t0 = time.perf_counter()
    _cuda.build(verbose=args.verbose_build)
    _cuda.lib()
    log(f"[build] nvcc sm_90a -> {_cuda.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")

    results: dict = {}
    check_kernels(results)
    if args.kernels_only:
        log(CARD)
        return 0
    launches = run_slice(results, profile=args.profile)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **results[name.split()[0]]}
        for name, (_, src, tpu) in KERNELS.items()
    ]
    print(CARD)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

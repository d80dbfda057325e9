#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lfsr_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check (one card)
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only
    python3 chip_smoke.py --train-only    # build + kernels + the training phase
    python3 chip_smoke.py --profile       # + torch.profiler traces of one dispatch / step each

Phases (any failure exits non-zero):
1. Card and build: print ``nvidia-smi`` name and power limit; build the
   Hopper kernels from ``lfsr_tpu_torch/csrc`` with nvcc (timed).
2. Kernels vs plain: each kernel against its plain PyTorch twin on the
   card, in float32 with TF32 off (tight bound) and in bfloat16 (loose
   bound), with kernel and twin times, at every shape the main paths give
   it: K1 scan, K4 cross-scan gather, K5 cross-scan scatter and K6 window
   attention at the tiled-eval shapes and at a Real whole-scene dispatch
   ([4, 640, 880, 64]); those four and K7 LayerNorm + local branch at a
   Synth one ([4, 720, 720, 64]); K2 (the scan's training forward, whose y
   must equal K1's bit for bit), K3 (its adjoint) and K4-K7 at the batch-8
   training shape ([8, 160, 160, 64], scan [8, 25600, 80]).
3. Training: ``Config(batch_size=8)`` (bf16, augmentation, masked
   pre-training with 2 masked views in epoch 0, dropout, composite_v8,
   AdamW) from the seeded init on 32 synthetic SAI-160 patch pairs; 2
   untimed warm-up steps, then ``run_epoch`` of 4 steps: launch counts per
   step (K2/K3/K4/K5/K7 12, K6 2, K1 0), finite loss/PSNR/SSIM, ms/step,
   steps/s, peak memory. A batch holding a NaN must leave the parameters
   and the optimizer's inner state as they were. One float32 step's
   parameter gradients on the kernels against the plain twins (batch 4,
   the smallest batch at K7's gate).
4. Tiled eval: the full-width flagship LFMambaX (64 channels, 12 blocks,
   d_state 16, bf16 activations) from a seeded random init, tiled
   ``evaluate_sets`` of one synthetic 5x5 scene (128^2 LR, 512^2 HR per
   view): launch counts, finite SR, agreement with the plain twins, finite
   PSNR/SSIM beside bicubic, ms/scene.
5. Whole-scene eval, ``Config()`` defaults (the flagship's default path):
   4 scenes at the NTIRE Synth geometry (500^2 HR) and 4 at the Real one
   (432x624 HR), one dispatch each: launch counts per dispatch (K7 on the
   square Synth mosaic only), finite SR and metrics, ms/scene and peak
   memory; one scene per geometry against the plain twins.
6. Submission: ``infer_submission`` of 16 Synth + 16 Real synthetic scenes
   into a temporary directory; the NTIRE validator must report no error.
7. Prints the card, the kernels' JSON line, then the final result line.

Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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

# NTIRE test geometries, HR view (height, width) (lfsr_tpu/tools/submission.py)
SYNTH_HR = (500, 500)
REAL_HR = (432, 624)
TILED_HR = (512, 512)
# scenes per geometry: whole-scene eval, submission
EVAL_SCENES, SUBMISSION_SCENES = 4, 16

# per-parameter gradient of one float32 train step, kernels vs plain twins:
# max|g_kernel - g_plain| <= bound * max(1, max|g_plain|)
GRAD_BOUND = 1e-4

# launches per flagship forward (12 blocks, window attention after 2 phases)
PER_FORWARD = {"K1 selective_scan_proj": 12, "K4 cross_scan_gather": 12,
               "K5 cross_scan_scatter": 12, "K6 window_mha_fused": 2, "K7 ln_msl": 12}
# launches per train step: K2 in place of K1 forward, K3 in backward (K4-K7
# have no backward kernel: their gradient is the plain twin's, as on the TPU)
PER_STEP = {"K1 selective_scan_proj": 0, "K2 selective_scan_proj_states": 12,
            "K3 selective_scan_proj_bwd": 12, "K4 cross_scan_gather": 12,
            "K5 cross_scan_scatter": 12, "K6 window_mha_fused": 2, "K7 ln_msl": 12}
TRAIN_PATCHES, TRAIN_STEPS, TRAIN_WARMUP = 32, 4, 2


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


def kernel_cases(dtype, g: torch.Generator):
    """Yields (kernel, where, operands) at the main paths' shapes, each made
    on the card when it is reached: K2, K3 and K4-K7 at the batch-8 train
    step (160x160 SAI patches; 64 channels, Di 80, d_state 16, dt rank 4);
    K1/K4/K5/K6 at tiled eval (minibatch 2); all five eval kernels at a
    Synth whole-scene dispatch; K1/K4/K5/K6 at a Real one (K7 is not taken
    on the non-square Real mosaic)."""
    from lfsr_tpu_torch.ops import scan

    dev = DEVICE

    def rn(*shape, s=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dt)

    C, Di, N, R, T, heads, c4 = 64, 80, 16, 4, 64, 4, 16
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(Di, 1)

    def operands(name, B, H, W):
        L = H * W
        if name in ("K1", "K2"):
            return (rn(B, L, Di, s=0.5, dt=dtype), rn(B, L, R + 2 * N, s=0.5, dt=dtype),
                    rn(R, Di, s=0.3), rn(Di, s=0.1), A, torch.ones(Di, device=dev))
        if name == "K3":  # the saved states come from K2 on the same operands
            u, dbc, wdt, bdt = (rn(B, L, Di, s=0.5, dt=dtype), rn(B, L, R + 2 * N, s=0.5, dt=dtype),
                                rn(R, Di, s=0.3), rn(Di, s=0.1))
            states = scan.selective_scan_proj_states(u, dbc, wdt, bdt, A, torch.ones(Di, device=dev))[1]
            return u, dbc, rn(B, L, Di, dt=dtype), wdt, bdt, A, states
        if name == "K4":
            return rn(B, H, W, C, dt=dtype), 1 + rn(C, s=0.2), rn(C, s=0.1)
        if name == "K5":
            return (rn(B, L, C, dt=dtype), rn(B, H, W, C, dt=dtype),
                    rn(C, C, s=0.125, dt=dtype), torch.full((1,), 0.15, device=dev))
        if name == "K6":
            return (rn(B, H, W, C, dt=dtype), rn(C, 3 * C, s=0.125), rn(C, C, s=0.125),
                    1 + rn(C, s=0.2), rn(C, s=0.1), rn(T, heads * T, s=0.02),
                    torch.full((1,), 0.25, device=dev))
        return (rn(B, H, W, C, dt=dtype), 1 + rn(C, s=0.2), rn(C, s=0.1),
                rn(c4, C, s=0.125, dt=dtype), rn(C - c4, C, s=0.125, dt=dtype),
                rn(3, 3, C - c4, s=0.3, dt=dtype))

    def mosaic(hr):  # a whole-scene dispatch: 4 mosaics of 5x5 LR views padded
        # by 8 and rounded up to a multiple of 8 (720x720 Synth, 640x880 Real)
        return [4, *(5 * (-(-(side // 4 + 16) // 8) * 8) for side in hr)]

    for where, shape, names in (("train", (8, 160, 160), ("K2", "K3", "K4", "K5", "K6", "K7")),
                                ("tiled", (2, 160, 160), ("K1", "K4", "K5", "K6")),
                                ("synth", mosaic(SYNTH_HR), ("K1", "K4", "K5", "K6", "K7")),
                                ("real", mosaic(REAL_HR), ("K1", "K4", "K5", "K6"))):
        for name in names:
            yield name, where, operands(name, *shape)


def by_rows(plain, rows=(0, 1)):
    """A scan twin one batch row at a time (the arguments at ``rows`` are
    sliced; outputs are joined along the batch). Each row is an independent
    recurrence; the twin's log-depth scan holds several [rows, L, 80, 16]
    float32 tensors (~2.7 GB each for one row at a whole-scene L)."""
    def run(*args):
        outs = [plain(*(a[i : i + 1] if j in rows else a for j, a in enumerate(args)))
                for i in range(args[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)
    return run


def check_kernels(results: dict) -> None:
    from lfsr_tpu_torch.ops import _cuda, block, cross_scan as cs
    from lfsr_tpu_torch.ops import scan, window_attention as wa

    pairs = {
        "K1": (scan.selective_scan_proj, scan.selective_scan_proj_plain),
        "K2": (scan.selective_scan_proj_states, by_rows(scan.selective_scan_proj_states_plain)),
        "K3": (scan.selective_scan_proj_bwd,
               by_rows(scan.selective_scan_proj_bwd_plain, rows=(0, 1, 2, 6))),
        "K4": (cs.cross_scan_gather, cs.cross_scan_gather_plain),
        "K5": (cs.cross_scan_scatter, cs.cross_scan_scatter_plain),
        "K6": (wa.window_mha_fused, wa.window_mha_plain),
        "K7": (block.ln_msl, block.ln_msl_plain),
    }
    # the JSON line reports each kernel on the flagship's bf16 path (K6 runs
    # on the float32 residual stream): K1 and K4-K7 at the Synth whole-scene
    # dispatch, the default eval's shape where all five run; K2 and K3 at
    # the batch-8 train step
    main = {k: (torch.float32 if k == "K6" else torch.bfloat16,
                "train" if k in ("K2", "K3") else "synth") for k in pairs}
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    for dtype, bound in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for name, where, args in kernel_cases(dtype, g):
            kern, plain = pairs[name]
            # K1 at a whole-scene L: ~0.1 s per launch, ~1 s per twin call
            big = name == "K1" and where != "tiled"
            if big:
                plain = by_rows(plain)
            got = kern(*args)
            torch.cuda.synchronize()
            if name == "K2":  # the training forward's y is K1's, bit for bit
                same = torch.equal(got[0], scan.selective_scan_proj(*args))
                log(f"[kernels] K2 {str(dtype)[6:]:8s} y == K1 y bit for bit: {same}")
                assert same, f"K2 {dtype}: y differs from K1's"
            want = plain(*args)
            torch.cuda.synchronize()
            # each output against its own scale (K3's dA sums over L, its du
            # does not); float32 outputs (K2's states, all of K3's) from
            # bf16 inputs are computed in float32 on both sides
            outs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            errs = [_cuda.twin_error(a, b) for a, b in outs]
            bounds = [(bound if a.dtype == torch.bfloat16 else F32_BOUND) * sc
                      for (a, _), (_, sc) in zip(outs, errs)]
            del got, want, outs
            err = max(e for e, _ in errs)
            ok = all(np.isfinite(e) and e <= b for (e, _), b in zip(errs, bounds))
            ms = time_ms(lambda: kern(*args), *((5, 1) if big else (20, 3)))
            plain_ms = time_ms(lambda: plain(*args), *((1, 0) if big else (5, 1)))
            log(f"[kernels] {name} {str(dtype)[6:]:8s} {where:5s} shape {tuple(args[0].shape)} "
                f"max|d|={', '.join(f'{e:.3e}' for e, _ in errs)} "
                f"bound={', '.join(f'{b:.3e}' for b in bounds)} {'ok' if ok else 'FAIL'} | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({CARD})")
            if not ok:
                raise AssertionError(f"{name} {dtype} {where}: max|d| {errs} > {bounds}")
            if (dtype, where) == main[name]:
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            del args
            torch.cuda.empty_cache()


def make_scene(rng: np.random.Generator, name: str, hr: tuple, ang: int = 5, scale: int = 4):
    """Synthetic 5x5 light field with HR views of ``hr`` = (height, width):
    a smooth random texture shifted per view by a disparity; LR is a
    scale x scale box downsample of each view; neutral chroma (Cb = Cr =
    0.5), so the RGB recomposition gives grey-level views."""
    from lfsr_tpu_torch.data.datasets import TestScene

    h, w = hr
    pad = 16
    yy, xx = np.mgrid[0 : h + 2 * pad, 0 : w + 2 * pad].astype(np.float64)
    tex = np.zeros_like(yy)
    for _ in range(6):
        fy, fx = rng.uniform(0.005, 0.05, 2)
        ph = rng.uniform(0, 2 * np.pi)
        tex += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    disp = rng.uniform(0.5, 1.5)
    views = np.empty((ang, ang, h, w), np.float32)
    for u in range(ang):
        for v in range(ang):
            dy = int(round(disp * (u - ang // 2)))
            dx = int(round(disp * (v - ang // 2)))
            views[u, v] = tex[pad + dy : pad + dy + h, pad + dx : pad + dx + w]
    lr = views.reshape(ang, ang, h // scale, scale, w // scale, scale).mean(axis=(3, 5))
    to_sai = lambda a: a.transpose(0, 2, 1, 3).reshape(ang * a.shape[2], ang * a.shape[3])
    return TestScene(
        name=name, dataset="Synthetic", lr_y=to_sai(lr).astype(np.float32),
        hr_y=to_sai(views), sr_cbcr=np.full((ang * h, ang * w, 2), 0.5, np.float32),
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


def profile_run(fn, label: str, reps: int = 3) -> None:
    """``fn()`` (one dispatch or one step) under torch.profiler after one
    untimed call: device time by kernel and the device's idle share (one
    minus the union of kernel intervals over the host wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
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
    log(f"[profile] one {label}: wall "
        f"{wall_us / reps / 1e3:.2f} ms, device busy {busy_us / reps / 1e3:.2f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}, {len(kernels) // reps} kernel launches, "
        f"{len(rows)} kernel names ({CARD})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile]   {e.self_device_time_total / reps / 1e3:8.3f} ms "
            f"{e.count // reps:5d}x  {e.key[:90]}")


def profile_dispatch(model, x, label: str, reps: int = 3) -> None:
    def run():
        with torch.inference_mode():
            model(x)
    profile_run(run, f"{label} dispatch {tuple(x.shape)}", reps)


def eval_launches(forwards: int, k7_forwards: int) -> dict:
    """Launches of ``forwards`` eval forwards, ``k7_forwards`` of them at
    K7's gate (K2 and K3 do not run in eval)."""
    return {k: n * (k7_forwards if k == "K7 ln_msl" else forwards) for k, n in PER_FORWARD.items()}


def check_counts(counts: dict, want: dict, what: str) -> None:
    """Every kernel's launches == ``want`` (0 for a kernel it does not list)."""
    for name, n in counts.items():
        assert n == want.get(name, 0), f"{what}: {name} {n} launches, expected {want.get(name, 0)}"
    log(f"[{what}] launches {counts}")


def check_views(views: dict, scenes, ang: int, s: int, what: str) -> None:
    for sc in scenes:
        v = views[sc.name]
        h0, w0 = sc.lr_y.shape[0] // ang, sc.lr_y.shape[1] // ang
        assert tuple(v.shape) == (ang, ang, h0 * s, w0 * s), (what, sc.name, v.shape)
        assert torch.isfinite(v).all(), f"{what} {sc.name}: non-finite SR"


def run_tiled(model) -> None:
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.ops import _cuda, launch_counts, reset_launch_counts
    from lfsr_tpu_torch.ops.tiling import lf_divide, tile_counts
    from lfsr_tpu_torch.train.evaluate import evaluate_sets

    cfg = Config(whole_scene_for_test=False)
    scene = make_scene(np.random.default_rng(SEED), "tiled0", TILED_HR)
    ang, s = cfg.angRes, cfg.scale_factor
    h0 = scene.lr_y.shape[0] // ang
    n1, n2 = tile_counts(h0, h0, cfg.patch_size_for_test, cfg.stride_for_test)
    dispatches = -(-n1 * n2 // cfg.minibatch_for_test)
    log(f"[tiled] 1 scene, {n1 * n2} patches, {dispatches} dispatches of "
        f"{cfg.minibatch_for_test}")
    evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=lambda m: None)  # warm-up
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=log, keep_views=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_counts(launch_counts(), eval_launches(dispatches, 0), "tiled")
    views = res["Synthetic"]["views"]
    check_views(views, [scene], ang, s, "tiled")
    assert np.isfinite(res["Synthetic"]["psnr"]) and np.isfinite(res["Synthetic"]["ssim"]), res

    with _cuda.force_plain():
        res_plain = evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=lambda m: None,
                                  keep_views=True)
    sr_err = (views[scene.name] - res_plain["Synthetic"]["views"][scene.name]).abs().max().item()
    log(f"[tiled] kernels vs plain twins: max|d SR| = {sr_err:.3e} (bound {SR_BOUND}); "
        f"PSNR {res['Synthetic']['psnr']:.4f} vs {res_plain['Synthetic']['psnr']:.4f} dB")
    assert sr_err <= SR_BOUND, sr_err
    p, ss = bicubic_baseline(scene, ang, s)
    log(f"[tiled] PSNR/SSIM {res['Synthetic']['psnr']:.4f}/{res['Synthetic']['ssim']:.4f} "
        f"(random init) | bicubic {p:.4f}/{ss:.4f}")
    log(f"[tiled] {1e3 * seconds:.1f} ms/scene, {1 / seconds:.4f} scenes/s ({CARD})")


def run_whole(model, synth: list, real: list, profile: bool) -> dict:
    """Whole-scene evaluate_sets, one dispatch per geometry (both warmed up
    first), each between its own count reset and read. Returns the
    launches of both."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.ops import KERNELS, _cuda, launch_counts, reset_launch_counts
    from lfsr_tpu_torch.train.evaluate import _whole_pad_batch, evaluate_sets

    cfg = Config()
    ang, s, mb = cfg.angRes, cfg.scale_factor, cfg.whole_scene_minibatch
    assert len(synth) == len(real) == mb, "one dispatch per geometry"
    for subset, scenes in (("Synth", synth), ("Real", real)):  # warm-up, both geometries
        evaluate_sets(model, {subset: scenes}, cfg, log=lambda m: None)
    torch.cuda.synchronize()
    if profile:
        x = _whole_pad_batch(torch.as_tensor(np.stack([sc.lr_y for sc in synth]), device=DEVICE),
                             ang, cfg.whole_scene_pad)[0][..., None]
        profile_dispatch(model, x, "whole-scene Synth", reps=1)

    total = dict.fromkeys(KERNELS, 0)
    views = {}
    for subset, scenes, k7 in (("Synth", synth, 1), ("Real", real, 0)):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate_sets(model, {subset: scenes}, cfg, log=log, keep_views=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts(counts, eval_launches(1, k7), f"whole {subset}")
        total = {k: total[k] + counts[k] for k in total}
        check_views(res[subset]["views"], scenes, ang, s, f"whole {subset}")
        assert np.isfinite(res[subset]["psnr"]) and np.isfinite(res[subset]["ssim"]), res
        views[subset] = res[subset]["views"][scenes[0].name]
        p, ss = bicubic_baseline(scenes[0], ang, s)
        mosaic = _whole_pad_batch(torch.zeros(1, *scenes[0].lr_y.shape), ang,
                                  cfg.whole_scene_pad)[0].shape[1:]
        log(f"[whole {subset}] {len(scenes)} scenes of {tuple(scenes[0].lr_y.shape)} LR -> one "
            f"dispatch of {mb}x{tuple(mosaic)}: {1e3 * seconds / len(scenes):.1f} ms/scene, "
            f"{len(scenes) / seconds:.4f} scenes/s, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; PSNR/SSIM "
            f"{res[subset]['psnr']:.4f}/{res[subset]['ssim']:.4f} (random init), scene 0 "
            f"bicubic {p:.4f}/{ss:.4f} ({CARD})")
        del res
    torch.cuda.empty_cache()

    # one scene per geometry on the plain twins (minibatch 1: the K1 twin's
    # log-depth scan holds several [B, L, 80, 16] float32 tensors)
    one = cfg.replace(whole_scene_minibatch=1)
    for subset, scenes in (("Synth", synth), ("Real", real)):
        with _cuda.force_plain():
            res_plain = evaluate_sets(model, {subset: scenes[:1]}, one, log=lambda m: None,
                                      keep_views=True)
        err = (views[subset] - res_plain[subset]["views"][scenes[0].name]).abs().max().item()
        log(f"[whole {subset}] kernels vs plain twins, scene 0: max|d SR| = {err:.3e} "
            f"(bound {SR_BOUND}); PSNR on the twins {res_plain[subset]['psnr']:.4f} dB")
        assert err <= SR_BOUND, (subset, err)
        del res_plain
        torch.cuda.empty_cache()
    return total


def run_submission(model, synth: list, real: list) -> None:
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.inference import infer_submission
    from lfsr_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = Config()
    dispatches = {k: -(-len(v) // cfg.whole_scene_minibatch)
                  for k, v in (("Synth", synth), ("Real", real))}
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = infer_submission(model, {"Synth": synth, "Real": real}, cfg, Path(tmp) / "sub",
                               log=lambda m: None)
        seconds = time.perf_counter() - t0
        zip_mb = (Path(tmp) / "sub.zip").stat().st_size / 2**20
    check_counts(launch_counts(), eval_launches(sum(dispatches.values()), dispatches["Synth"]),
                 "submission")
    log(f"[submission] {len(synth)} Synth + {len(real)} Real scenes -> BMP tree + "
        f"{zip_mb:.1f} MiB zip in {seconds:.1f} s; validator: {rep.checks} checks, "
        f"{len(rep.errors)} errors, {len(rep.warnings)} warnings ({CARD})")
    for e in rep.errors[:10]:
        log(f"[submission]   ERROR: {e}")
    assert rep.ok, rep.errors


def train_data(n: int):
    """``n`` synthetic SAI-160 training pairs: 5x5 views of 128^2 HR (a
    640^2 HR mosaic) and their 4x4 box-downsampled 160^2 LR mosaics."""
    from lfsr_tpu_torch.data.datasets import TrainArrays

    rng = np.random.default_rng(SEED + 2)
    scenes = [make_scene(rng, f"patch{i:02d}", (128, 128)) for i in range(n)]
    return TrainArrays(lr=np.stack([sc.lr_y for sc in scenes]),
                       hr=np.stack([sc.hr_y for sc in scenes]))


def param_snapshot(trainer) -> dict:
    st = trainer.opt_state
    return {**{k: p.detach().clone() for k, p in trainer.params.items()},
            "mu": st.mu_flat.clone(), "nu": st.nu_flat.clone(), "count": st.count.clone()}


def check_grads(sd, data) -> None:
    """One float32 train step's parameter gradients on the kernels vs on the
    plain twins (``_cuda.force_plain``), same batch and dropout mask. Batch
    4: the smallest batch of 160^2 patches at K7's gate, so all of K2-K7
    are on the path."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.ops import _cuda, launch_counts, reset_launch_counts
    from lfsr_tpu_torch.train import masking
    from lfsr_tpu_torch.train.trainer import Trainer, generators

    cfg = Config(batch_size=4, compute_dtype="float32")
    ang = cfg.angRes
    trainer = Trainer(cfg, TRAIN_STEPS, sd, device=DEVICE)
    lr = torch.as_tensor(data.lr[:4], device=DEVICE)[..., None]
    hr = torch.as_tensor(data.hr[:4], device=DEVICE)[..., None]
    view_keep = torch.ones(ang, ang, device=DEVICE)
    view_keep[0, 1] = view_keep[3, 3] = 0
    x = masking.apply_view_mask(lr, view_keep, ang)
    sracm_keep = masking.draw_sracm(torch.Generator(DEVICE).manual_seed(SEED),
                                    lr.shape[1] // ang, lr.shape[2] // ang, cfg.mask_start_ratio)
    x = masking.apply_sracm(x, sracm_keep, ang)
    grads = []
    for plain in (False, True):
        dropout = generators(cfg, 0, DEVICE)["dropout"]  # the same masks in both runs
        reset_launch_counts()
        with _cuda.force_plain() if plain else contextlib.nullcontext():
            sr = trainer.model(x, generator=dropout)
            loss = trainer.loss_fn(sr, hr)
            grads.append(dict(zip(trainer.params, torch.autograd.grad(
                loss, list(trainer.params.values())))))
        counts = launch_counts()
        if not plain:
            check_counts(counts, PER_STEP, "grad check, kernels")
        else:
            assert not any(counts.values()), counts
        del sr, loss
    worst, worst_rel = ("", 0.0), 0.0
    for k, gk in grads[0].items():
        gp = grads[1][k]
        err = (gk - gp).abs().max().item()
        top = gp.abs().max().item()
        assert np.isfinite(err) and err <= GRAD_BOUND * max(1.0, top), (k, err, top)
        worst = max(worst, (k, err / max(1.0, top)), key=lambda t: t[1])
        worst_rel = max(worst_rel, err / max(top, 1e-30))
    log(f"[train] float32 gradients, kernels vs plain twins, {len(grads[0])} parameters: "
        f"max |d g| / max(1, max|g|) = {worst[1]:.3e} ({worst[0]}; bound {GRAD_BOUND}), "
        f"max |d g| / max|g| = {worst_rel:.3e}")
    del trainer, grads
    torch.cuda.empty_cache()


def run_train(sd, profile: bool) -> dict:
    """The batch-8 train step: warm-up, a timed ``run_epoch``, the NaN-skip
    and the gradient checks. Returns the epoch's launches."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from lfsr_tpu_torch.train.masking import num_masked_views
    from lfsr_tpu_torch.train.trainer import Draws, Trainer, generators

    cfg = Config(batch_size=8)
    ratio = cfg.mask_start_ratio  # epoch 0
    mask_k = num_masked_views(cfg.angRes, ratio)
    data = train_data(TRAIN_PATCHES)
    trainer = Trainer(cfg, TRAIN_STEPS, sd, device=DEVICE)
    lr = torch.as_tensor(data.lr[:8], device=DEVICE)
    hr = torch.as_tensor(data.hr[:8], device=DEVICE)
    gens = generators(cfg, 0, DEVICE)
    for _ in range(TRAIN_WARMUP):  # untimed: first-call set-up, allocator growth
        trainer.train_step(lr, hr, trainer.draw(gens, lr.shape, mask_k, ratio), gens["dropout"])
    torch.cuda.synchronize()
    if profile:
        profile_run(lambda: trainer.train_step(lr, hr, trainer.draw(gens, lr.shape, mask_k, ratio),
                                               gens["dropout"]),
                    f"train step {tuple(lr.shape)}", reps=2)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer.run_epoch(data, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_counts(counts, {k: n * TRAIN_STEPS for k, n in PER_STEP.items()}, "train")
    assert all(np.isfinite(res[k]) for k in ("loss", "psnr", "ssim")), res
    assert res["mask_ratio"] == ratio, res
    log(f"[train] LFMambaX batch {cfg.batch_size} of {tuple(lr.shape[1:])} LR / "
        f"{tuple(hr.shape[1:])} HR, {cfg.compute_dtype}, augment + {mask_k} masked views + SRACM + "
        f"dropout, composite_v8, AdamW: {TRAIN_STEPS} steps in {seconds:.3f} s = "
        f"{1e3 * seconds / TRAIN_STEPS:.1f} ms/step, {TRAIN_STEPS / seconds:.4f} steps/s, peak "
        f"mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss {res['loss']:.5f}, "
        f"PSNR/SSIM {res['psnr']:.4f}/{res['ssim']:.4f} (random init) ({CARD})")

    # a batch holding a NaN: no update, the optimizer's inner state unchanged
    before = param_snapshot(trainer)
    bad = lr.clone()
    bad[0, 7, 11] = float("nan")
    m = trainer.train_step(bad, hr, Draws(), gens["dropout"])
    after = param_snapshot(trainer)
    same = all(torch.equal(before[k], after[k]) for k in before)
    st = trainer.opt_state
    log(f"[train] NaN batch: loss {m['loss'].item()}, parameters and inner state unchanged: "
        f"{same}; notfinite_count {int(st.notfinite_count)}, last_finite {bool(st.last_finite)}")
    assert same and not np.isfinite(m["loss"].item())
    assert int(st.notfinite_count) == 1 and not bool(st.last_finite)
    del trainer, before, after
    torch.cuda.empty_cache()
    check_grads(sd, data)
    return counts


def run_slice(profile: bool = False, eval_paths: bool = True) -> dict:
    from lfsr_tpu_torch.bridge import init_params, param_count
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import get_model, whole_scene_default

    cfg = Config()
    assert whole_scene_default(cfg), "the flagship's default eval is whole-scene"
    sd = init_params(cfg, torch.Generator().manual_seed(SEED))
    n_params = param_count(sd)
    assert n_params == 693_998, n_params
    model = get_model(cfg, device=DEVICE)
    model.load_state_dict(sd)
    log(f"[slice] LFMambaX {n_params} params, {cfg.compute_dtype}")
    launches = run_train(sd, profile)
    if not eval_paths:
        return launches
    if profile:
        from lfsr_tpu_torch.ops.tiling import lf_divide

        scene = make_scene(np.random.default_rng(SEED), "profile", TILED_HR)
        x = lf_divide(torch.as_tensor(scene.lr_y, device=DEVICE), cfg.angRes,
                      cfg.patch_size_for_test, cfg.stride_for_test)
        profile_dispatch(model, x[: cfg.minibatch_for_test, ..., None].contiguous(), "tiled")
    run_tiled(model)

    rng = np.random.default_rng(SEED + 1)
    synth = [make_scene(rng, f"synth{i:02d}", SYNTH_HR) for i in range(SUBMISSION_SCENES)]
    real = [make_scene(rng, f"real{i:02d}", REAL_HR) for i in range(SUBMISSION_SCENES)]
    whole = run_whole(model, synth[:EVAL_SCENES], real[:EVAL_SCENES], profile)
    run_submission(model, synth, real)
    return {k: launches[k] + whole[k] for k in launches}


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, shared memory, spills)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one train step and one tiled and one whole-scene dispatch "
                         "with torch.profiler")
    ap.add_argument("--train-only", action="store_true",
                    help="after the kernel phase run the training phase only (no eval paths)")
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
    # launches: the training phase's epoch + the two whole-scene dispatches,
    # each counted between its own reset and read
    launches = run_slice(profile=args.profile, eval_paths=not args.train_only)
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

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lfsr_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check (one card)
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only
    python3 chip_smoke.py --train-only    # build + kernels + the flagship's training phase
    python3 chip_smoke.py --model EPIT    # build + K8 vs plain + EPIT's phases only
    python3 chip_smoke.py --scan-impl gated  # build + K9b vs plain + 'gated' whole-scene eval
    python3 chip_smoke.py --scan-impl fused  # build + K9c vs plain + 'fused' whole-scene eval
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
   training shape ([8, 160, 160, 64], scan [8, 25600, 80]); K9b (the
   gated-epilogue scan + out-projection of ``scan_impl='gated'``) and K9c
   (the fused Mamba inner pipeline of ``'fused'``) at the tiled scan shape
   [2, 25600, 80], the Synth one [4, 518400, 80] and the Real one
   [4, 563200, 80]; K8 (EPIT's
   banded-mask attention) at EPIT's tiled eval (q/k/v [320, 160, 128]) and
   batch-8 training ([1280, 160, 128]), with EPIT's own mask, beside one
   ``scaled_dot_product_attention`` call on the same inputs (the library
   yardstick, used nowhere in the port). Each kernel's bound: the larger of
   its bytes (inputs read once, outputs written once) over 3.35 TB/s and
   its operations over the peak rate for their type (matrix products of
   bf16 operands 989 TFLOP/s, float32 and all other arithmetic 67 TFLOP/s).
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
   memory; one scene per geometry against the plain twins. Then the same
   8 scenes under ``Config(model_kwargs={'scan_impl': impl})`` for impl in
   ('gated', 'fused'), with the same seeded parameters: K9b or K9c 12 per
   dispatch and K1 0, ms/scene beside the default's, scene 0 of both
   geometries within the SR bound of the default path's views, Synth
   scene 0 against the plain twins.
6. Submission: ``infer_submission`` of 16 Synth + 16 Real synthetic scenes
   into a temporary directory; the NTIRE validator must report no error.
7. EPIT (64 channels, 5 AltFilters, 8 heads, bf16, seeded init), its
   default tiled ``evaluate_sets`` of one 512^2-HR scene (32 dispatches of
   2 patches: K8 320 launches, nothing else) against the plain twins, and
   its batch-8 train step (L1, augmentation, masking, AdamW; K8 10 per
   step), the NaN-skip and one float32 step's gradients kernels vs twins.
8. Prints the card, the kernels' JSON line, then the final result line.

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
# kernel-path vs plain-path SR views of a full bf16 model:
# max|d| <= SR_BOUND * max(1, max|plain SR|). The flagship's views lie in
# ~[0, 1]; EPIT's from a random init reach ~10, where one bf16 ulp of its
# head's output is already 0.0625
SR_BOUND = 5e-2

# NTIRE test geometries, HR view (height, width) (lfsr_tpu/tools/submission.py)
SYNTH_HR = (500, 500)
REAL_HR = (432, 624)
TILED_HR = (512, 512)
# scenes per geometry: whole-scene eval, submission
EVAL_SCENES, SUBMISSION_SCENES = 4, 16

# per-parameter gradient of one float32 train step, kernels vs plain twins:
# max|g_kernel - g_plain| <= bound * max(1, max|g_plain|); batch 4, the
# smallest batch of 160^2 patches at K7's gate (so all of K2-K7 are on the
# flagship's path)
GRAD_BOUND = 1e-4
GRAD_BATCH = 4

# launches per flagship forward (12 blocks, window attention after 2 phases)
PER_FORWARD = {"K1 selective_scan_proj": 12, "K4 cross_scan_gather": 12,
               "K5 cross_scan_scatter": 12, "K6 window_mha_fused": 2, "K7 ln_msl": 12}
# launches per train step: K2 in place of K1 forward, K3 in backward (K4-K7
# have no backward kernel: their gradient is the plain twin's, as on the TPU)
PER_STEP = {"K1 selective_scan_proj": 0, "K2 selective_scan_proj_states": 12,
            "K3 selective_scan_proj_bwd": 12, "K4 cross_scan_gather": 12,
            "K5 cross_scan_scatter": 12, "K6 window_mha_fused": 2, "K7 ln_msl": 12}
TRAIN_PATCHES, TRAIN_STEPS, TRAIN_WARMUP = 32, 4, 2
# EPIT: K8 at both EPI passes of each of its 5 AltFilters, forward only (its
# gradient is the plain twin's, as on the TPU)
EPIT_PER_FORWARD = {"K8 masked_mha_fused": 10}
# the flagship's opt-in scans: each takes K1's place, 12 per forward
SCAN_IMPL_KERNELS = {"gated": "K9b scan_gated_fused", "fused": "K9c mamba_inner_fused"}
# at a whole-scene L the scans' twins run one batch row at a time: the
# arguments of each kernel that are sliced along the batch
BY_ROWS = {"K1": (0, 1), "K9b": (0, 1, 3, 4, 5), "K9c": (0, 1)}

# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, matrix
# products of bf16 operands on the tensor cores, float32 on the CUDA cores
HBM_BYTES_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12


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


def kernel_cases(dtype, g: torch.Generator, only=None):
    """Yields (kernel, where, operands) at the main paths' shapes, each made
    on the card when it is reached: K2, K3 and K4-K7 at the batch-8 train
    step (160x160 SAI patches; 64 channels, Di 80, d_state 16, dt rank 4);
    K1/K4/K5/K6 and K9b/K9c (the ``scan_impl='gated'``/``'fused'`` scans,
    their operands laid out as the model gives them: B and C slices of dbc,
    xs and z halves of in_proj's output) at tiled eval (minibatch 2); all
    five eval kernels and K9b/K9c at a Synth whole-scene dispatch;
    K1/K4/K5/K6 and K9b/K9c at a Real one (K7 is not taken on the
    non-square Real mosaic); K8 at EPIT's tiled eval (2 patches x
    5 x 32 sequences) and batch-8 train step (8 x 5 x 32), L = 5 x 32 tokens
    of 128 channels, 8 heads, EPIT's own band mask. ``only``: the kernels
    to yield (default all)."""
    from lfsr_tpu_torch.models.epit import HEADS, band_mask
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
        if name == "K9b":  # u, dt_raw (pre-softplus), A, B, C, z, D, W_out
            dbc, xz = rn(B, L, R + 2 * N, s=0.5, dt=dtype), rn(B, L, 2 * Di, dt=dtype)
            return (rn(B, L, Di, s=0.5, dt=dtype), rn(B, L, Di, s=0.5, dt=dtype), A,
                    dbc[..., R : R + N], dbc[..., R + N :], xz[..., Di:],
                    torch.ones(Di, device=dev), rn(Di, C, s=Di**-0.5, dt=dtype), True)
        if name == "K9c":  # xs, z, wconv, bconv, Wx, Wdt, bdt, A, D
            xz = rn(B, L, 2 * Di, dt=dtype)
            return (xz[..., :Di], xz[..., Di:], rn(4, Di, s=0.3), rn(Di, s=0.1),
                    rn(Di, R + 2 * N, s=Di**-0.5), rn(R, Di, s=0.3), rn(Di, s=0.1), A,
                    torch.ones(Di, device=dev))
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
                                ("tiled", (2, 160, 160), ("K1", "K4", "K5", "K6", "K9b", "K9c")),
                                ("synth", mosaic(SYNTH_HR),
                                 ("K1", "K4", "K5", "K6", "K7", "K9b", "K9c")),
                                ("real", mosaic(REAL_HR),
                                 ("K1", "K4", "K5", "K6", "K9b", "K9c"))):
        for name in names:
            if only is None or name in only:
                yield name, where, operands(name, *shape)
    if only is None or "K8" in only:
        mask = band_mask(5, 32, 10, 11, torch.device(dev))  # EPIT's mask, L = 160
        for where, seqs in (("epit-tiled", 2 * 5 * 32), ("epit-train", 8 * 5 * 32)):
            yield "K8", where, (*(rn(seqs, 160, 2 * C, dt=dtype) for _ in range(3)), mask, HEADS)


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


def work(name: str, args, outs) -> tuple[int, float, float]:
    """(bytes, matrix-product FLOPs, other FLOPs) of one call of kernel
    ``name`` on ``args`` giving ``outs``: every tensor operand read once and
    every output written once; the FLOPs of the function itself (a fused
    multiply-add is 2, an exp or a compare 1), not of how a kernel computes it."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if isinstance(t, torch.Tensor))
    x = args[0]
    if name in ("K1", "K2", "K3"):  # per (b, t, channel): dt projection, softplus,
        # exp(delta A), state update and C.h for each of the N states
        wdt, A = (args[3], args[5]) if name == "K3" else (args[2], args[4])
        R, N = wdt.shape[0], A.shape[1]
        per = 2 * R + 6 + (21 if name == "K3" else 7) * N  # K3: recompute + adjoint
        return nbytes, 0.0, float(x.numel() * per)
    if name == "K9b":  # per (b, t, channel): softplus, the scan as K1's, D skip and the
        # silu(z) gate; the out-projection's product (of W_out's dtype)
        N, Dout = args[2].shape[1], args[7].shape[1]
        return nbytes, 2.0 * x.numel() * Dout, float(x.numel() * (6 + 7 * N + 7))
    if name == "K9c":  # per (b, t, channel), all float32: conv + bias + SiLU, x_proj's
        # product, the dt projection + softplus, the scan, D skip and the gate
        KC, J, R, N = args[2].shape[0], args[4].shape[1], args[5].shape[0], args[7].shape[1]
        return nbytes, 0.0, float(x.numel() * (2 * KC + 5 + 2 * J + 2 * R + 6 + 7 * N + 7))
    if name == "K4":  # LayerNorm
        return nbytes, 0.0, 8.0 * x.numel()
    if name == "K5":  # C x C mix + scaled residual
        x = args[1]
        return nbytes, 2.0 * x.numel() * x.shape[-1], 3.0 * x.numel()
    if name == "K6":  # LN, qkv, 64-token window attention (4 heads), out-proj
        C, T, heads = x.shape[-1], 64, 4
        P = x.numel() // C
        return nbytes, float(P * C * (8 * C + 4 * T)), float(P * (10 * C + 4 * heads * T))
    if name == "K7":  # LN, folded head 1x1, depthwise 3x3, mix, lrelu, residual
        C, c4 = x.shape[-1], args[3].shape[0]
        P = x.numel() // C
        return nbytes, 2.0 * P * C * C, float(P * (11 * C + 18 * (C - c4)))
    if name == "K8":  # q k^T and p v per head; mask add, max, exp, sum
        B, L, D = x.shape
        return nbytes, 4.0 * B * L * L * D, 4.0 * B * args[4] * L * L
    raise KeyError(name)


def bound(name: str, args, outs) -> tuple[float, str, float]:
    """The least time the card could take for this call: the larger of its
    bytes over HBM_BYTES_S and its operations over the peak for their type
    (matrix products of bf16 operands on the tensor cores, the rest on the
    CUDA cores). Returns (ms, what sets it, the CUDA-core floor in ms: all of
    the FLOPs as float32 on the CUDA cores)."""
    nbytes, mm, other = work(name, args, outs)
    mm_peak = BF16_TENSOR_FLOPS if args[0].dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_S, mm / mm_peak + other / F32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, 1e3 * (mm + other) / F32_FLOPS


def sdpa_call(q, k, v, mask, heads):
    """K8's function as one PyTorch call (the library yardstick): q, k, v
    viewed as [B, heads, L, hd], the mask in q's dtype. Returns the call and
    a function that lays its output out as [B, L, D]."""
    B, L, D = q.shape
    split = lambda a: a.view(B, L, heads, D // heads).transpose(1, 2)
    qs, ks, vs, m = split(q), split(k), split(v), mask.to(q.dtype)
    run = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=m)
    return run, lambda o: o.transpose(1, 2).reshape(B, L, D)


def check_kernels(results: dict, only=None) -> None:
    from lfsr_tpu_torch.ops import _cuda, block, cross_scan as cs
    from lfsr_tpu_torch.ops import masked_attention as ma, scan, window_attention as wa

    pairs = {
        "K1": (scan.selective_scan_proj, scan.selective_scan_proj_plain),
        "K2": (scan.selective_scan_proj_states, by_rows(scan.selective_scan_proj_states_plain)),
        "K3": (scan.selective_scan_proj_bwd,
               by_rows(scan.selective_scan_proj_bwd_plain, rows=(0, 1, 2, 6))),
        "K4": (cs.cross_scan_gather, cs.cross_scan_gather_plain),
        "K5": (cs.cross_scan_scatter, cs.cross_scan_scatter_plain),
        "K6": (wa.window_mha_fused, wa.window_mha_plain),
        "K7": (block.ln_msl, block.ln_msl_plain),
        "K8": (ma.masked_mha_fused, ma.masked_mha_plain),
        "K9b": (scan.scan_gated_fused, scan.scan_gated_plain),
        "K9c": (scan.mamba_inner_fused, scan.mamba_inner_plain),
    }
    # the JSON line reports each kernel on its model's bf16 path (K6 runs
    # on the flagship's float32 residual stream): K1 and K4-K7 at the Synth
    # whole-scene dispatch, the flagship's default eval, where all five run;
    # K2 and K3 at the batch-8 train step; K8 at EPIT's default (tiled) eval
    main = {k: (torch.float32 if k == "K6" else torch.bfloat16,
                "train" if k in ("K2", "K3") else "epit-tiled" if k == "K8" else "synth")
            for k in pairs}
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    for dtype, tol in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for name, where, args in kernel_cases(dtype, g, only):
            kern, plain = pairs[name]
            # the scans at a whole-scene L: ~0.1 s per launch, ~1 s per twin call
            big = name in BY_ROWS and where != "tiled"
            if big:
                plain = by_rows(plain, BY_ROWS[name])
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
            bounds = [(tol if a.dtype == torch.bfloat16 else F32_BOUND) * sc
                      for (a, _), (_, sc) in zip(outs, errs)]
            bound_ms, bound_by, core_ms = bound(name, args, [a for a, _ in outs])
            library_ms, lib_note = None, ""
            if name == "K8":
                run, layout = sdpa_call(*args)
                lib_err = (layout(run()).float() - want.float()).abs().max().item()
                library_ms = time_ms(run)
                lib_note = (f", scaled_dot_product_attention {library_ms:.4f} ms "
                            f"(max|d| vs twin {lib_err:.3e})")
            del got, want, outs
            err = max(e for e, _ in errs)
            ok = all(np.isfinite(e) and e <= b for (e, _), b in zip(errs, bounds))
            ms = time_ms(lambda: kern(*args), *((5, 1) if big else (20, 3)))
            plain_ms = time_ms(lambda: plain(*args), *((1, 0) if big else (5, 1)))
            log(f"[kernels] {name} {str(dtype)[6:]:8s} {where:5s} shape {tuple(args[0].shape)} "
                f"max|d|={', '.join(f'{e:.3e}' for e, _ in errs)} "
                f"bound={', '.join(f'{b:.3e}' for b in bounds)} {'ok' if ok else 'FAIL'} | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_note}; least time "
                f"{bound_ms:.4f} ms ({bound_by}), CUDA-core floor {core_ms:.4f} ms ({CARD})")
            if not ok:
                raise AssertionError(f"{name} {dtype} {where}: max|d| {errs} > {bounds}")
            if (dtype, where) == main[name]:
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": library_ms}
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


def per_forward(impl: str = "pallas") -> dict:
    """Launches per flagship forward under ``scan_impl=impl``: K9b or K9c
    in K1's place."""
    if impl == "pallas":
        return PER_FORWARD
    out = {k: n for k, n in PER_FORWARD.items() if k != "K1 selective_scan_proj"}
    return {**out, SCAN_IMPL_KERNELS[impl]: PER_FORWARD["K1 selective_scan_proj"]}


def eval_launches(forwards: int, k7_forwards: int, impl: str = "pallas") -> dict:
    """Launches of ``forwards`` eval forwards, ``k7_forwards`` of them at
    K7's gate (K2 and K3 do not run in eval)."""
    return {k: n * (k7_forwards if k == "K7 ln_msl" else forwards)
            for k, n in per_forward(impl).items()}


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


def run_tiled(model, cfg, per_dispatch: dict, what: str = "tiled") -> dict:
    """Tiled ``evaluate_sets`` of one synthetic 512^2-HR scene with ``cfg``
    (warmed up first): launch counts (``per_dispatch`` per model call),
    finite SR and metrics, the SR views against the same run on the plain
    twins, bicubic beside it, ms/scene. Returns the timed run's launches."""
    from lfsr_tpu_torch.ops import _cuda, launch_counts, reset_launch_counts
    from lfsr_tpu_torch.ops.tiling import tile_counts
    from lfsr_tpu_torch.train.evaluate import evaluate_sets

    scene = make_scene(np.random.default_rng(SEED), "tiled0", TILED_HR)
    ang, s = cfg.angRes, cfg.scale_factor
    h0 = scene.lr_y.shape[0] // ang
    n1, n2 = tile_counts(h0, h0, cfg.patch_size_for_test, cfg.stride_for_test)
    dispatches = -(-n1 * n2 // cfg.minibatch_for_test)
    log(f"[{what}] {cfg.model_name}: 1 scene, {n1 * n2} patches, {dispatches} dispatches of "
        f"{cfg.minibatch_for_test}")
    evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=lambda m: None)  # warm-up
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=log, keep_views=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_counts(counts, {k: n * dispatches for k, n in per_dispatch.items()}, what)
    views = res["Synthetic"]["views"]
    check_views(views, [scene], ang, s, what)
    assert np.isfinite(res["Synthetic"]["psnr"]) and np.isfinite(res["Synthetic"]["ssim"]), res

    with _cuda.force_plain():
        res_plain = evaluate_sets(model, {"Synthetic": [scene]}, cfg, log=lambda m: None,
                                  keep_views=True)
    sr_err, scale = _cuda.twin_error(views[scene.name], res_plain["Synthetic"]["views"][scene.name])
    log(f"[{what}] kernels vs plain twins: max|d SR| = {sr_err:.3e} (bound {SR_BOUND} x "
        f"{scale:.3f}); PSNR {res['Synthetic']['psnr']:.4f} vs "
        f"{res_plain['Synthetic']['psnr']:.4f} dB")
    assert sr_err <= SR_BOUND * scale, (sr_err, scale)
    p, ss = bicubic_baseline(scene, ang, s)
    log(f"[{what}] PSNR/SSIM {res['Synthetic']['psnr']:.4f}/{res['Synthetic']['ssim']:.4f} "
        f"(random init) | bicubic {p:.4f}/{ss:.4f}")
    log(f"[{what}] {1e3 * seconds:.1f} ms/scene, {1 / seconds:.4f} scenes/s ({CARD})")
    return counts


def whole_dispatches(model, cfg, synth: list, real: list, what: str, impl: str = "pallas"):
    """Whole-scene ``evaluate_sets`` of ``cfg``, one dispatch per geometry
    (both warmed up first), each between its own count reset and read:
    launch counts per dispatch (K7 on the square Synth mosaic only), finite
    SR and metrics, ms/scene and peak memory. Returns the launches of both
    and, per geometry, (scene 0's SR views, ms/scene, peak GiB)."""
    from lfsr_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from lfsr_tpu_torch.train.evaluate import _whole_pad_batch, evaluate_sets

    ang, s, mb = cfg.angRes, cfg.scale_factor, cfg.whole_scene_minibatch
    assert len(synth) == len(real) == mb, "one dispatch per geometry"
    for subset, scenes in (("Synth", synth), ("Real", real)):  # warm-up, both geometries
        evaluate_sets(model, {subset: scenes}, cfg, log=lambda m: None)
    torch.cuda.synchronize()

    total = dict.fromkeys(KERNELS, 0)
    out = {}
    for subset, scenes, k7 in (("Synth", synth, 1), ("Real", real, 0)):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate_sets(model, {subset: scenes}, cfg, log=log, keep_views=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts(counts, eval_launches(1, k7, impl), f"{what} {subset}")
        total = {k: total[k] + counts[k] for k in total}
        check_views(res[subset]["views"], scenes, ang, s, f"{what} {subset}")
        assert np.isfinite(res[subset]["psnr"]) and np.isfinite(res[subset]["ssim"]), res
        ms, peak = 1e3 * seconds / len(scenes), torch.cuda.max_memory_allocated() / 2**30
        out[subset] = (res[subset]["views"][scenes[0].name], ms, peak)
        p, ss = bicubic_baseline(scenes[0], ang, s)
        mosaic = _whole_pad_batch(torch.zeros(1, *scenes[0].lr_y.shape), ang,
                                  cfg.whole_scene_pad)[0].shape[1:]
        log(f"[{what} {subset}] {len(scenes)} scenes of {tuple(scenes[0].lr_y.shape)} LR -> one "
            f"dispatch of {mb}x{tuple(mosaic)}: {ms:.1f} ms/scene, "
            f"{len(scenes) / seconds:.4f} scenes/s, peak mem {peak:.2f} GiB; PSNR/SSIM "
            f"{res[subset]['psnr']:.4f}/{res[subset]['ssim']:.4f} (random init), scene 0 "
            f"bicubic {p:.4f}/{ss:.4f} ({CARD})")
        del res
    torch.cuda.empty_cache()
    return total, out


def plain_scene0(model, cfg, subset: str, scenes: list):
    """Scene 0's SR views on the plain twins (minibatch 1: the scan twins'
    log-depth scans hold several [B, L, 80, 16] float32 tensors)."""
    from lfsr_tpu_torch.ops import _cuda
    from lfsr_tpu_torch.train.evaluate import evaluate_sets

    with _cuda.force_plain():
        res = evaluate_sets(model, {subset: scenes[:1]}, cfg.replace(whole_scene_minibatch=1),
                            log=lambda m: None, keep_views=True)
    torch.cuda.empty_cache()
    return res[subset]["views"][scenes[0].name], res[subset]["psnr"]


def run_whole(model, synth: list, real: list, profile: bool):
    """Whole-scene evaluate_sets of ``Config()`` (``whole_dispatches``) and
    one scene per geometry against the plain twins. Returns the launches
    and, per geometry, (scene 0's views, ms/scene, peak GiB)."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.ops import _cuda
    from lfsr_tpu_torch.train.evaluate import _whole_pad_batch

    cfg = Config()
    total, out = whole_dispatches(model, cfg, synth, real, "whole")
    if profile:
        x = _whole_pad_batch(torch.as_tensor(np.stack([sc.lr_y for sc in synth]), device=DEVICE),
                             cfg.angRes, cfg.whole_scene_pad)[0][..., None]
        profile_dispatch(model, x, "whole-scene Synth", reps=1)
    for subset, scenes in (("Synth", synth), ("Real", real)):
        want, psnr = plain_scene0(model, cfg, subset, scenes)
        err, scale = _cuda.twin_error(out[subset][0], want)
        log(f"[whole {subset}] kernels vs plain twins, scene 0: max|d SR| = {err:.3e} "
            f"(bound {SR_BOUND} x {scale:.3f}); PSNR on the twins {psnr:.4f} dB")
        assert err <= SR_BOUND * scale, (subset, err, scale)
    return total, out


def run_scan_impl(impl: str, sd, synth: list, real: list, ref: dict, profile: bool) -> dict:
    """The flagship's whole-scene eval under ``model_kwargs={'scan_impl':
    impl}`` (K9b or K9c in K1's place) with the 'pallas' model's seeded
    parameters: ``whole_dispatches`` of the same scenes, ms/scene beside the
    'pallas' path's (``ref``, from ``whole_dispatches``), scene 0 of both
    geometries against the 'pallas' path's views (the same function, other
    roundings) and Synth scene 0 against the plain twins. Returns the
    launches."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import get_model
    from lfsr_tpu_torch.ops import _cuda
    from lfsr_tpu_torch.train.evaluate import _whole_pad_batch

    cfg = Config(model_kwargs={"scan_impl": impl})
    model = get_model(cfg, device=DEVICE)
    assert list(model.state_dict()) == list(sd), "the param tree depends on scan_impl"
    model.load_state_dict(sd)
    what = f"{impl} whole"
    total, out = whole_dispatches(model, cfg, synth, real, what, impl)
    if profile:
        x = _whole_pad_batch(torch.as_tensor(np.stack([sc.lr_y for sc in synth]), device=DEVICE),
                             cfg.angRes, cfg.whole_scene_pad)[0][..., None]
        profile_dispatch(model, x, f"{impl} whole-scene Synth", reps=1)
    for subset in ("Synth", "Real"):
        (views, ms, peak), (pviews, pms, ppeak) = out[subset], ref[subset]
        err, scale = _cuda.twin_error(views, pviews)
        log(f"[{what} {subset}] {ms:.1f} ms/scene ({1e3 / ms:.4f} scenes/s), peak {peak:.2f} "
            f"GiB | 'pallas' {pms:.1f} ms/scene ({1e3 / pms:.4f} scenes/s), peak {ppeak:.2f} "
            f"GiB; scene 0 vs 'pallas': max|d SR| = {err:.3e} (bound {SR_BOUND} x {scale:.3f}) "
            f"({CARD})")
        assert err <= SR_BOUND * scale, (impl, subset, err, scale)
    want, psnr = plain_scene0(model, cfg, "Synth", synth)
    err, scale = _cuda.twin_error(out["Synth"][0], want)
    log(f"[{what} Synth] kernels vs plain twins, scene 0: max|d SR| = {err:.3e} "
        f"(bound {SR_BOUND} x {scale:.3f}); PSNR on the twins {psnr:.4f} dB")
    assert err <= SR_BOUND * scale, (impl, err, scale)
    del model
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


def check_grads(sd, data, cfg, per_step: dict, what: str) -> None:
    """One float32 train step's parameter gradients on the kernels vs on the
    plain twins (``_cuda.force_plain``), same batch (``cfg``'s size), masks
    and dropout mask."""
    from lfsr_tpu_torch.ops import _cuda, launch_counts, reset_launch_counts
    from lfsr_tpu_torch.train import masking
    from lfsr_tpu_torch.train.trainer import Trainer, generators

    ang, nb = cfg.angRes, cfg.batch_size
    trainer = Trainer(cfg, TRAIN_STEPS, sd, device=DEVICE)
    lr = torch.as_tensor(data.lr[:nb], device=DEVICE)[..., None]
    hr = torch.as_tensor(data.hr[:nb], device=DEVICE)[..., None]
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
            sr = trainer.forward(x, dropout)
            loss = trainer.loss_fn(sr, hr)
            grads.append(dict(zip(trainer.params, torch.autograd.grad(
                loss, list(trainer.params.values())))))
        counts = launch_counts()
        if not plain:
            check_counts(counts, per_step, f"{what} grad check, kernels")
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
    log(f"[{what}] float32 gradients, batch {nb}, kernels vs plain twins, {len(grads[0])} "
        f"parameters: max |d g| / max(1, max|g|) = {worst[1]:.3e} ({worst[0]}; bound "
        f"{GRAD_BOUND}), max |d g| / max|g| = {worst_rel:.3e}")
    del trainer, grads
    torch.cuda.empty_cache()


def run_train(sd, cfg, per_step: dict, profile: bool, what: str) -> dict:
    """The batch-8 train step of ``cfg``'s model: warm-up, a timed
    ``run_epoch``, the NaN-skip and the gradient checks. Returns the
    epoch's launches."""
    from lfsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from lfsr_tpu_torch.train.masking import num_masked_views
    from lfsr_tpu_torch.train.trainer import _TRAIN_FLAG_MODELS, Draws, Trainer, generators

    ratio = cfg.mask_start_ratio  # epoch 0
    mask_k = num_masked_views(cfg.angRes, ratio)
    data = train_data(TRAIN_PATCHES)
    trainer = Trainer(cfg, TRAIN_STEPS, sd, device=DEVICE)
    lr = torch.as_tensor(data.lr[: cfg.batch_size], device=DEVICE)
    hr = torch.as_tensor(data.hr[: cfg.batch_size], device=DEVICE)
    gens = generators(cfg, 0, DEVICE)
    for _ in range(TRAIN_WARMUP):  # untimed: first-call set-up, allocator growth
        trainer.train_step(lr, hr, trainer.draw(gens, lr.shape, mask_k, ratio), gens["dropout"])
    torch.cuda.synchronize()
    if profile:
        profile_run(lambda: trainer.train_step(lr, hr, trainer.draw(gens, lr.shape, mask_k, ratio),
                                               gens["dropout"]),
                    f"{cfg.model_name} train step {tuple(lr.shape)}", reps=2)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer.run_epoch(data, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_counts(counts, {k: n * TRAIN_STEPS for k, n in per_step.items()}, what)
    assert all(np.isfinite(res[k]) for k in ("loss", "psnr", "ssim")), res
    assert res["mask_ratio"] == ratio, res
    extras = " + dropout" if cfg.model_name in _TRAIN_FLAG_MODELS else ""
    log(f"[{what}] {cfg.model_name} batch {cfg.batch_size} of {tuple(lr.shape[1:])} LR / "
        f"{tuple(hr.shape[1:])} HR, {cfg.compute_dtype}, augment + {mask_k} masked views + SRACM"
        f"{extras}, its registered loss, AdamW: {TRAIN_STEPS} steps in {seconds:.3f} s = "
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
    log(f"[{what}] NaN batch: loss {m['loss'].item()}, parameters and inner state unchanged: "
        f"{same}; notfinite_count {int(st.notfinite_count)}, last_finite {bool(st.last_finite)}")
    assert same and not np.isfinite(m["loss"].item())
    assert int(st.notfinite_count) == 1 and not bool(st.last_finite)
    del trainer, before, after
    torch.cuda.empty_cache()
    check_grads(sd, data, cfg.replace(batch_size=GRAD_BATCH, compute_dtype="float32"), per_step,
                what)
    return counts


def profile_tiled_dispatch(model, cfg) -> None:
    from lfsr_tpu_torch.ops.tiling import lf_divide

    scene = make_scene(np.random.default_rng(SEED), "profile", TILED_HR)
    x = lf_divide(torch.as_tensor(scene.lr_y, device=DEVICE), cfg.angRes,
                  cfg.patch_size_for_test, cfg.stride_for_test)
    profile_dispatch(model, x[: cfg.minibatch_for_test, ..., None].contiguous(),
                     f"{cfg.model_name} tiled")


def seeded_model(cfg, n_params: int):
    """``cfg``'s model on the card from the seeded init; returns (model, state_dict)."""
    from lfsr_tpu_torch.bridge import init_params, param_count
    from lfsr_tpu_torch.models.registry import get_model

    sd = init_params(cfg, torch.Generator().manual_seed(SEED))
    assert param_count(sd) == n_params, param_count(sd)
    model = get_model(cfg, device=DEVICE)
    model.load_state_dict(sd)
    log(f"[slice] {cfg.model_name} {n_params} params, {cfg.compute_dtype}")
    return model, sd


def add(*counts: dict) -> dict:
    """Launch counts of several runs, summed per kernel."""
    return {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}


def flagship_scenes():
    """The 16 Synth and 16 Real synthetic scenes of the flagship's
    whole-scene and submission phases (the first EVAL_SCENES of each are
    the whole-scene phases')."""
    rng = np.random.default_rng(SEED + 1)
    synth = [make_scene(rng, f"synth{i:02d}", SYNTH_HR) for i in range(SUBMISSION_SCENES)]
    real = [make_scene(rng, f"real{i:02d}", REAL_HR) for i in range(SUBMISSION_SCENES)]
    return synth, real


def run_flagship(profile: bool = False, eval_paths: bool = True) -> dict:
    """The flagship's paths: train, tiled, whole-scene (under each
    ``scan_impl``), submission. Returns the launches of their timed runs,
    each counted between its own reset and read."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import whole_scene_default

    cfg = Config()
    assert whole_scene_default(cfg), "the flagship's default eval is whole-scene"
    model, sd = seeded_model(cfg, 693_998)
    launches = run_train(sd, Config(batch_size=8), PER_STEP, profile, "train")
    if not eval_paths:
        return launches
    if profile:
        profile_tiled_dispatch(model, cfg)
    tiled = run_tiled(model, Config(whole_scene_for_test=False), eval_launches(1, 0))

    synth, real = flagship_scenes()
    whole, ref = run_whole(model, synth[:EVAL_SCENES], real[:EVAL_SCENES], profile)
    impls = [run_scan_impl(impl, sd, synth[:EVAL_SCENES], real[:EVAL_SCENES], ref, profile)
             for impl in SCAN_IMPL_KERNELS]
    run_submission(model, synth, real)
    return add(launches, tiled, whole, *impls)


def run_scan_impl_alone(impl: str, profile: bool = False) -> dict:
    """``--scan-impl``: the 'pallas' model's whole-scene dispatches (the
    reference, counted and timed but not held against the twins), then
    ``run_scan_impl``. Returns the launches of the latter."""
    from lfsr_tpu_torch.config import Config

    model, sd = seeded_model(Config(), 693_998)
    synth, real = (sc[:EVAL_SCENES] for sc in flagship_scenes())
    ref = whole_dispatches(model, Config(), synth, real, "whole")[1]
    del model
    torch.cuda.empty_cache()
    return run_scan_impl(impl, sd, synth, real, ref, profile)


def run_epit(profile: bool = False, eval_paths: bool = True) -> dict:
    """EPIT's paths: its default tiled eval and its batch-8 train step.
    Returns their launches."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import whole_scene_default

    cfg = Config(model_name="EPIT")
    assert not whole_scene_default(cfg), "EPIT's default eval is tiled"
    model, sd = seeded_model(cfg, 1_470_080)
    runs = []
    if eval_paths:
        if profile:
            profile_tiled_dispatch(model, cfg)
        runs.append(run_tiled(model, cfg, EPIT_PER_FORWARD, "epit tiled"))
    del model
    torch.cuda.empty_cache()
    runs.append(run_train(sd, cfg.replace(batch_size=8), EPIT_PER_FORWARD, profile, "epit train"))
    return add(*runs)


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, shared memory, spills)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one train step and one tiled (and for the flagship one "
                         "whole-scene) dispatch of each model with torch.profiler")
    ap.add_argument("--train-only", action="store_true",
                    help="after the kernel phase run the training phases only (no eval paths)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--model", choices=("LFMambaX", "EPIT"),
                      help="only this model's kernels and phases (default: both)")
    only.add_argument("--scan-impl", choices=tuple(SCAN_IMPL_KERNELS),
                      help="only the flagship's kernel of this scan_impl (K9b or K9c) and its "
                           "whole-scene eval phase, beside the 'pallas' dispatches it is held "
                           "against")
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

    names = {"LFMambaX": ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K9b", "K9c"),
             "EPIT": ("K8",), None: None}[args.model]
    if args.scan_impl:
        names = (SCAN_IMPL_KERNELS[args.scan_impl].split()[0],)
    results: dict = {}
    check_kernels(results, names)
    if args.kernels_only:
        log(CARD)
        return 0
    eval_paths = not args.train_only
    runs = []
    if args.scan_impl:
        eval_paths = True
        runs.append(run_scan_impl_alone(args.scan_impl, profile=args.profile))
    if args.model in (None, "LFMambaX") and not args.scan_impl:
        runs.append(run_flagship(profile=args.profile, eval_paths=eval_paths))
    if args.model in (None, "EPIT") and not args.scan_impl:
        runs.append(run_epit(profile=args.profile, eval_paths=eval_paths))
    launches = add(*runs)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **results[name.split()[0]]}
        for name, (_, src, tpu) in KERNELS.items() if name.split()[0] in results
    ]
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    assert not (eval_paths and missing), f"kernels never launched on their paths: {missing}"
    print(CARD)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

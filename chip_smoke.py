#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lfsr_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check (one card)
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only
    python3 chip_smoke.py --train-only    # build + kernels + the training phases (and K9a's op)
    python3 chip_smoke.py --entry-only    # build + the flagship's kernels + the entry-point phase
    python3 chip_smoke.py --model EPIT    # build + K8 and K13 vs plain + EPIT's phases only
    python3 chip_smoke.py --model LFT     # build + K8, K12 and K13 vs plain + LFT's phases only
    python3 chip_smoke.py --model LF_DET  # build + K15 vs plain + LF-DET's phases only
    python3 chip_smoke.py --scan-impl gated  # build + K9b vs plain + 'gated' whole-scene eval + train
    python3 chip_smoke.py --scan-impl fused  # build + K9c vs plain + 'fused' whole-scene eval + train
    python3 chip_smoke.py --d-state-24    # build + K1-K3, K9a-K9c at d_state 24 vs plain only
    python3 chip_smoke.py --profile       # + torch.profiler traces of one dispatch / step each

Phases (any failure exits non-zero):
1. Card and build: print ``nvidia-smi`` name and power limit; build the
   Hopper kernels from ``lfsr_tpu_torch/csrc`` with nvcc (timed).
2. Kernels vs plain: each kernel against its plain PyTorch twin on the
   card, in float32 with TF32 off (tight bound) and in bfloat16 (loose
   bound), with kernel and twin times, at every shape the main paths give
   it: K1 scan, K4 cross-scan gather, K5 cross-scan scatter, K6 window
   attention and K7 LayerNorm + local branch at the tiled-eval shapes and
   at a Real whole-scene dispatch ([4, 640, 880, 64]), where K7 takes the
   float32 residual stream (its float32-input mode); those five at a
   Synth one ([4, 720, 720, 64]), K7 on x rounded to bf16 (the TPU's
   gate); K2 (the scan's training forward, whose y must equal K1's bit for
   bit), K3 (its adjoint) and K4-K7 at the batch-8 training shape ([8,
   160, 160, 64], scan [8, 25600, 80]); K9b (the gated-epilogue scan + out-projection of ``scan_impl='gated'``) and K9c
   (the fused Mamba inner pipeline of ``'fused'``) at the tiled scan shape
   [2, 25600, 80], the Synth one [4, 518400, 80] and the Real one
   [4, 563200, 80]; K10 (the HLFR tail: expansion matmul + lrelu + folded
   out-conv, on the last stage's map at twice the LR side) at the tiled
   [2, 320, 320, 64], train [8, 320, 320, 64], Synth [4, 1440, 1440, 64]
   and Real [4, 1280, 1760, 64] shapes; K11 (the depthwise convs outside
   the blocks) at the tiled, Synth and Real LR maps at each of the
   flagship's sites (3x3 at dilation 1 and 3, LSFL's 1x3 / 3x1 dilation-5
   "once" convs) and at twice each map's side (HLFR's Conv_12), "tap" held
   bit for bit to the chain and "once" within an ulp of ``F.conv2d``
   (cuDNN, timed beside it as the library yardstick); K9a (the op-level scan
   ``selective_scan_fused``, delta given after or before softplus) at the
   tiled, train and Synth scan shapes; K8 (EPIT's
   banded-mask attention) at EPIT's tiled eval (q/k/v [320, 160, 128]) and
   batch-8 training ([1280, 160, 128]), with EPIT's own mask, beside one
   ``scaled_dot_product_attention`` call on the same inputs (the library
   yardstick, used nowhere in the port), and which of K8's two kernels
   took each call (bf16: the tensor-core one; float32: the CUDA-core one);
   K8 at LFT's AngTrans call (q/k/v [16384, 25, 64], 8 heads of 8, a zero
   [25, 25] mask: every LR pixel of 16 tiles of 32 x 32, the CUDA-core
   kernel in both dtypes), beside the same library call; K12 (LFT's 5x5
   banded spatial attention) at its tiled call (q/k/v [400, 1024, 128],
   8 heads of 16: 16 tiles x 25 views of 32 x 32 tokens), and which of its
   kernels took it (bf16: tensor cores; float32: CUDA cores); K13 (the
   LayerNorm with the code's add folded in) at LFT's AngTrans call (x
   [16384, 25, 64] + the float32 code [1, 25, 64]), its SpaTrans call
   ([400, 1024, 128] + the embedded code [1, 1024, 128] of the compute
   dtype) and EPIT's tiled call ([320, 160, 128], no code), beside one
   ``F.layer_norm`` of x alone (the library yardstick, used nowhere in the
   port); K14 (the Mamba's causal conv + SiLU, xs the first half of
   in_proj's output) at the train, tiled, Synth and Real scan shapes, held
   bit for bit to the chain, and which of its lanes it took (16 bytes at
   the flagship's Di 80); K15 (LF-DET's attention with no mask, 4 heads of
   16, k and v the two halves of one projection) at the four sites of a
   16-tile call (spatial q [400, 1024, 64] against k, v [400, 256, 64];
   the MacPI windows [16384, 25, 64], [4096, 100, 64], [1936, 225, 64]),
   also held to the float32 formula (bf16 within 2 bf16 ulps of its scale
   and no farther from it than the bf16 twin; float32 within 1e-5), beside
   the fastest of ``scaled_dot_product_attention``'s fused backends (flash,
   memory-efficient, cuDNN) that takes the call (the library yardstick),
   and which of its kernels took it (bf16: tensor cores; float32: CUDA
   cores),
   and of K6's (every flagship call: the tensor-core one, bf16x3), of K5's
   and K7's (bf16: the tensor-core ones), of K4's (every flagship call,
   bf16 and float32: the tile kernel). K1, K2,
   K3, K9a, K9b and K9c at d_state 24 (EfficientLFNetV7's default, at its
   widths: [8, 25600, 90], dt rank 5).
   K1 (bf16) also logs its chunk length Tc and the time of each of its
   three passes at the tiled, Synth and Real shapes (K1 and K2 run the
   chunk-parallel scan); K3 (f32 and bf16) its chunk count and the time of
   each of its passes (summaries, carry, adjoint, sum of dA: the
   chunk-parallel reverse scan). Each kernel's bound: the larger of
   its bytes (inputs read once, outputs written once) over 3.35 TB/s and
   its operations over the peak rate for their type (matrix products of
   bf16 operands 989 TFLOP/s and of float32 ones 495, the tensor cores'
   TF32 rate; all other arithmetic 67 TFLOP/s).
3. Training: ``Config(batch_size=8)`` (bf16, augmentation, masked
   pre-training with 2 masked views in epoch 0, dropout, composite_v8,
   AdamW) from the seeded init on 32 synthetic SAI-160 patch pairs; 2
   untimed warm-up steps, then ``run_epoch`` of 4 steps: launch counts per
   step (K2/K3/K4/K5/K7 12, K6 2, K10 1, K1 0, K11 13, its gradient the
   plain chain's, K14 0; every K5 and K7 launch on
   its tensor-core kernel, every K4 launch of every phase, the float32
   gradient checks too, on its tile kernel), finite loss/PSNR/SSIM,
   ms/step, steps/s, peak memory. A batch holding a NaN must leave the
   parameters and the optimizer's inner state as they were. One float32
   step's parameter gradients on the kernels against the plain twins
   (batch 4; K5 and K7 on their CUDA-core kernels). Then the same under
   ``Config(batch_size=8, model_kwargs={'scan_impl': impl})`` for impl in
   ('gated', 'fused'): K9b or K9c 12 per step in K2's place, K1/K2/K3 0
   (the scan's gradient is its twin's, the chunked scan).
4. Tiled eval: the full-width flagship LFMambaX (64 channels, 12 blocks,
   d_state 16, bf16 activations) from a seeded random init, tiled
   ``evaluate_sets`` of one synthetic 5x5 scene (128^2 LR, 512^2 HR per
   view): launch counts, finite SR, agreement with the plain twins, finite
   PSNR/SSIM beside bicubic, ms/scene.
5. Whole-scene eval, ``Config()`` defaults (the flagship's default path):
   4 scenes at the NTIRE Synth geometry (500^2 HR) and 4 at the Real one
   (432x624 HR), one dispatch each: launch counts per dispatch (K7 12 on
   both, K10 once, K11 13, K14 12), finite SR and metrics, ms/scene and peak
   memory; one scene per geometry against the plain twins. Then the same
   8 scenes under ``Config(model_kwargs={'scan_impl': impl})`` for impl in
   ('gated', 'fused'), with the same seeded parameters: K9b or K9c 12 per
   dispatch and K1 0, ms/scene beside the default's, scene 0 of both
   geometries within the SR bound of the default path's views, Synth
   scene 0 against the plain twins.
6. Entry points (``lfsr_tpu_torch.scripts.*``, what a user runs), in a
   temporary directory, from ``.npz`` files written there with numpy in the
   loaders' tree (32 SAI-160 training pairs; 4 Synth + 4 Real scenes for
   validation and test; 16 + 16 for the submission), the full-width
   flagship from the seeded init: ``train`` with ``--epoch 1 --batch_size
   8``, then ``--epoch 2``, which resumes from ``epoch_0000.pt``, and in a
   second log dir ``--epoch 2`` straight (``--warmup_epochs 2`` in all
   three: the learning rate of each of the 8 steps is then the same in
   both); each validates at its last epoch (one whole-scene dispatch per
   geometry); launches per step x steps + the validation dispatches; the
   resumed run's train state (parameters, both moments, the optimizer's
   four counts, the step) equal to the straight run's, no kernel of the
   path adds in an order that varies; two controls that restore
   ``epoch_0000.pt`` with the moments zeroed or the counts reset, then run
   epoch 1, must differ from the straight run; checkpoint size and
   save/restore seconds; ms/step.
   ``test`` on the 8 scenes with the resumed checkpoint (one dispatch a
   scene): its CSV equals ``evaluate_sets`` of the same model and scenes,
   one scene a dispatch. ``inference`` on the 16 + 16 scenes: the gate,
   the BMP tree, the zip, the validator VALID (and
   ``validate_submission``'s exit code 0); launches of its 8 dispatches.
   ``check_efficiency --bench --json``: 693,998 parameters, 18,118,185,344
   official MACs, PASS, latency and peak memory on the card.
7. EPIT (64 channels, 5 AltFilters, 8 heads, bf16, seeded init), its
   default tiled ``evaluate_sets`` of one 512^2-HR scene (32 dispatches of
   2 patches: K8 320 launches, K13 640, nothing else) against the plain
   twins, and its batch-8 train step (L1, augmentation, masking, AdamW; K8
   10 and K13 20 per step), the NaN-skip and one float32 step's gradients
   kernels vs twins; every K8 launch of the bf16 phases on its tensor-core kernel, of the
   float32 gradient check on its CUDA-core one.
8. LFT (64 channels, 4 blocks, bf16, seeded init), its default tiled
   ``evaluate_sets`` at the cell's 32 / 16 patches, 16 a call, of one
   512^2-HR scene (4 calls: K8 and K12 4 launches each a call, K13 16, 8
   of them with the code, read after a count reset, nothing else) against
   the plain twins, and its batch-8 train step (L1, augmentation, masking,
   AdamW; K8 and K12 4 per step, K13 16),
   the NaN-skip and one float32 step's gradients kernels vs twins; every
   K12 launch of the bf16 phases on its tensor-core kernel, of the float32
   gradient check on its CUDA-core one; every K8 launch (head dim 8) on its
   CUDA-core one.
9. LF-DET (64 channels, 4 mix blocks, bf16, seeded init), its default
   tiled ``evaluate_sets`` at the cell's 32 / 16 patches, 16 a call, of
   one 512^2-HR scene (4 calls: K15 20 launches a call, K13 48, K11 20,
   read after a count reset, nothing else) against the plain twins, and
   its batch-8 train step (L1, augmentation, masking, DropPath, AdamW; the
   same launches a step), the NaN-skip and one float32 step's gradients
   kernels vs twins; every K15 launch of the bf16 phases on its
   tensor-core kernel, of the float32 gradient check on its CUDA-core one;
   every K11 launch "once" rounding.
10. K9a's op: ``selective_scan_fused`` at the train scan shape [8, 25600,
   80], float32, forward and one backward of sum(y^2) on the kernel and on
   the plain twin: y and every gradient against the twin's.
11. Prints the card, the kernels' JSON line, then the final result line.

Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
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
# max|g_kernel - g_plain| <= bound * max(1, max|g_plain|); batch 4 of 160^2
# patches (K2-K7 and K10 on the flagship's path)
GRAD_BOUND = 1e-4
GRAD_BATCH = 4

# launches per flagship forward (12 blocks, window attention after 2 phases,
# the HLFR tail once, the 13 depthwise convs outside the blocks: 11 "tap", 2
# "once"; the Mamba's conv + SiLU once a block)
PER_FORWARD = {"K1 selective_scan_proj": 12, "K4 cross_scan_gather": 12,
               "K5 cross_scan_scatter": 12, "K6 window_mha_fused": 2, "K7 ln_msl": 12,
               "K10 hlfr_tail": 1, "K11 depthwise_conv": 13, "K14 conv_silu_fused": 12}
# launches per train step: K2 in place of K1 forward, K3 in backward (K4-K7,
# K10 and K11 have no backward kernel: their gradient is the plain twin's, as
# on the TPU; K14 none: under autograd the blocks run the conv + SiLU chain)
PER_STEP = {"K1 selective_scan_proj": 0, "K2 selective_scan_proj_states": 12,
            "K3 selective_scan_proj_bwd": 12, "K4 cross_scan_gather": 12,
            "K5 cross_scan_scatter": 12, "K6 window_mha_fused": 2, "K7 ln_msl": 12,
            "K10 hlfr_tail": 1, "K11 depthwise_conv": 13, "K14 conv_silu_fused": 0}
TRAIN_PATCHES, TRAIN_STEPS, TRAIN_WARMUP = 32, 4, 2
# EPIT: K8 at both EPI passes of each of its 5 AltFilters, forward only (its
# gradient is the plain twin's, as on the TPU)
# and K13 at the two LayerNorms of each of those 10 transformer calls
EPIT_PER_FORWARD = {"K8 masked_mha_fused": 10, "K13 layer_norm": 20}
# LFT: K8 (AngTrans) and K12 (SpaTrans) once a block, 4 blocks, K13 at the
# two LayerNorms of each of the 8 stages (the first with the code's add),
# forward only (their gradients are the plain twins', as on the TPU)
LFT_PER_FORWARD = {"K8 masked_mha_fused": 4, "K12 local_window_mha": 4, "K13 layer_norm": 16}
# of each model's K13 launches, the share that folds in a code
K13_CODE_SHARE = {"LFT": 0.5, "EPIT": 0.0}
LFT_PARAMS, LFT_TILES = 1_163_392, 16  # its parameters; tiles a call, as in lft.tiled_test
# LF-DET: K15 at each of its 20 attentions (2 spatial blocks and 3 window
# branches in each of 4 mix blocks), K13 at their 48 LayerNorms (the spatial
# reduction's too), K11 at their 20 Mix-FFN depthwise convs ("once"), forward
# only (the gradients are the plain twins')
LF_DET_PER_FORWARD = {"K15 dense_mha": 20, "K13 layer_norm": 48, "K11 depthwise_conv": 20}
LF_DET_PARAMS, LF_DET_HEADS = 1_686_668, 4
# K15's sites in a 16-tile call of lfdet.tiled_test: (B, Lq, Lk), 64 channels
LF_DET_SITES = {"lfdet-spa": (LFT_TILES * 25, 1024, 256), "lfdet-ws5": (LFT_TILES * 1024, 25, 25),
                "lfdet-ws10": (LFT_TILES * 256, 100, 100), "lfdet-ws15": (LFT_TILES * 121, 225, 225)}
# the flagship's opt-in scans: each takes K1's place, 12 per forward (in a
# train step too, where K2 and K3 then do not run: the gradient is the twin's)
SCAN_IMPL_KERNELS = {"gated": "K9b scan_gated_fused", "fused": "K9c mamba_inner_fused"}
# the scans at a whole-scene L: a kernel call takes ~0.1 s and its twin's
# ~0.5 s (the chunked scan's ~2,000 chunks), so each twin is timed by the one
# call that it is compared with, and the kernel over 5 calls
WHOLE, SCANS = ("synth", "real"), ("K1", "K9a", "K9b", "K9c")
# the scans at d_state 24, V7's widths (lfsr_tpu/models/efficient_lfnet_v7.py:
# 72 channels x expand 1.25, dt rank ceil(72 / 16))
N24_KERNELS = ("K1", "K2", "K3", "K9a", "K9b", "K9c")
N24_DIMS = {"Di": 90, "N": 24, "R": 5}

# the entry-point phase: the flagship's kernels, and the gate's numbers at
# the official input (the JAX package's CPU count, tests/test_torch_port_efficiency.py)
ENTRY_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K10", "K11", "K14")
GATE_PARAMS, GATE_MACS = 693_998, 18_118_185_344
# the gate's bench: 5 warm-up calls and 2 x 50 timed ones (tools/efficiency.latency_bench)
GATE_FORWARDS = 5 + 2 * 50

# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, matrix
# products on the tensor cores of bf16 and of TF32 operands, float32 on the
# CUDA cores
HBM_BYTES_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
F32_FLOPS = 67e12
# what each kernel path is, in the log
PATH_NAMES = {"mma": "tensor-core", "fma": "CUDA-core", "tile": "tile", "warp": "one-warp",
              "tap": "tap-rounding", "once": "once-rounding", "vec": "16-byte-lane",
              "elem": "one-channel-lane"}


def log(msg: str) -> None:
    print(msg, flush=True)


START = time.perf_counter()


def lap(what: str) -> None:
    """Log the seconds since the script started, after a phase."""
    log(f"[time] {what} done at {time.perf_counter() - START:.1f} s")


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


def kernel_cases(dtype, g: torch.Generator, only=None, n24_only: bool = False):
    """Yields (kernel, where, operands) at the main paths' shapes, each made
    on the card when it is reached: K2, K3 and K4-K7 at the batch-8 train
    step (160x160 SAI patches; 64 channels, Di 80, d_state 16, dt rank 4);
    K1/K4-K7 and K9b/K9c (the ``scan_impl='gated'``/``'fused'`` scans,
    their operands laid out as the model gives them: B and C slices of dbc,
    xs and z halves of in_proj's output) at tiled eval (minibatch 2); all
    five eval kernels and K9b/K9c at a Synth whole-scene dispatch;
    K1/K4-K7 and K9b/K9c at a Real one (K7 at tiled and Real in its
    float32-input mode: x float32, the weights in ``dtype``); K10 (the
    HLFR tail, on the last stage's map at twice the LR mosaic's side: Cz
    256, rr 4, kf folded from a seeded 3x3 kernel) at all four; K9a (the op-level scan, B and C slices of a dbc,
    D given) at train, tiled and Synth, with delta given after softplus
    ("where" as is) and before it ("where/raw"); K8 at EPIT's tiled eval
    (2 patches x 5 x 32 sequences) and batch-8 train step (8 x 5 x 32),
    L = 5 x 32 tokens of 128 channels, 8 heads, EPIT's own band mask, and
    at LFT's AngTrans call (16 x 32 x 32 sequences of 25 tokens, 64
    channels, 8 heads, a zero mask); K12 at LFT's SpaTrans call (16 tiles x
    25 views of 32 x 32 tokens, 128 channels, 8 heads, 5 x 5); K13 at LFT's
    AngTrans and SpaTrans LayerNorms with their codes and at EPIT's tiled
    one (x, gamma, beta, code or None, out dtype); K15 at LF-DET's four
    sites (q, and k and v the two halves of one [B, Lk, 128] projection,
    4 heads); K1,
    K2, K3 and K9a-K9c at d_state 24 ("v7-n24": [8, 25600, 90], dt rank 5;
    K9a with delta before softplus). ``only``: the kernels to yield (default
    all); ``n24_only``: the d_state 24 cases alone."""
    from lfsr_tpu_torch.models.epit import HEADS, band_mask
    from lfsr_tpu_torch.models.lfmambax import fold_out_conv
    from lfsr_tpu_torch.ops import scan

    dev = DEVICE

    def rn(*shape, s=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dt)

    C, T, heads, c4 = 64, 64, 4, 16

    def operands(name, B, H, W, raw=False, Di=80, N=16, R=4, f32_input=False):
        L = H * W
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(Di, 1)
        if name == "K9a":  # u, delta, A, B, C, D, chunk, pre_softplus
            dbc, delta = rn(B, L, R + 2 * N, s=0.5, dt=dtype), rn(B, L, Di, s=0.5)
            return (rn(B, L, Di, s=0.5, dt=dtype), (delta if raw else scan.softplus(delta)).to(dtype),
                    A, dbc[..., R : R + N], dbc[..., R + N :], 1 + rn(Di, s=0.1), 256, raw)
        if name == "K10":  # y, w1, kf, bias on the last HLFR stage's [B, 2H, 2W, C] map
            return (rn(B, 2 * H, 2 * W, C, dt=dtype), rn(C, 4 * C, s=C**-0.5, dt=dtype),
                    fold_out_conv(rn(3, 3, C, 1, s=0.1, dt=dtype), 2), rn(1, s=0.1, dt=dtype))
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
        if name == "K14":  # xs, in_proj's output's first half; wconv [4, Di] as the
            # model views conv1d's weight [Di, 1, 4]; bconv
            xz = rn(B, L, 2 * Di, dt=dtype)
            return xz[..., :Di], rn(Di, 1, 4, s=0.5)[:, 0, :].t(), rn(Di, s=0.5)
        if name == "K4":
            return rn(B, H, W, C, dt=dtype), 1 + rn(C, s=0.2), rn(C, s=0.1)
        if name == "K5":
            return (rn(B, L, C, dt=dtype), rn(B, H, W, C, dt=dtype),
                    rn(C, C, s=0.125, dt=dtype), torch.full((1,), 0.15, device=dev))
        if name == "K6":
            return (rn(B, H, W, C, dt=dtype), rn(C, 3 * C, s=0.125), rn(C, C, s=0.125),
                    1 + rn(C, s=0.2), rn(C, s=0.1), rn(T, heads * T, s=0.02),
                    torch.full((1,), 0.25, device=dev))
        # K7: x float32 in its float32-input mode (the block's residual stream)
        return (rn(B, H, W, C, dt=torch.float32 if f32_input else dtype), 1 + rn(C, s=0.2),
                rn(C, s=0.1), rn(c4, C, s=0.125, dt=dtype), rn(C - c4, C, s=0.125, dt=dtype),
                rn(3, 3, C - c4, s=0.3, dt=dtype))

    def k11_cases(where, B, H, W):
        """K11 at the flagship's depthwise sites on an LR map [B, H, W, C]
        (each: x, weight, dilation, rounding, bias): IFE / fusion / HLFR /
        LSFL 3x3 (d 1), SpatialAttention's d 3, LSFL's two EPI convs
        ("once", d 5); on HLFR's last stage at twice the side, 3x3
        (Conv_12)."""
        x = rn(B, H, W, C, dt=dtype)
        w33, ang = rn(C, 1, 3, 3, s=0.3), 5
        yield f"{where}/d1", (x, w33, 1, "tap", None)
        yield f"{where}/d3", (x, w33, 3, "tap", None)
        yield f"{where}/epi-h", (x, rn(C, 1, 1, 3, s=0.4), (1, ang), "once", None)
        yield f"{where}/epi-v", (x, rn(C, 1, 3, 1, s=0.4), (ang, 1), "once", None)
        del x
        yield f"{where}-hr/d1", (rn(B, 2 * H, 2 * W, C, dt=dtype), w33, 1, "tap", None)

    def mosaic(hr):  # a whole-scene dispatch: 4 mosaics of 5x5 LR views padded
        # by 8 and rounded up to a multiple of 8 (720x720 Synth, 640x880 Real)
        return [4, *(5 * (-(-(side // 4 + 16) // 8) * 8) for side in hr)]

    main = (("train", (8, 160, 160), ("K2", "K3", "K4", "K5", "K6", "K7", "K9a", "K10",
                                      "K14")),
            ("tiled", (2, 160, 160), ("K1", "K4", "K5", "K6", "K7", "K9a", "K9b", "K9c",
                                      "K10", "K11", "K14")),
            ("synth", mosaic(SYNTH_HR),
             ("K1", "K4", "K5", "K6", "K7", "K9a", "K9b", "K9c", "K10", "K11", "K14")),
            ("real", mosaic(REAL_HR), ("K1", "K4", "K5", "K6", "K7", "K9b", "K9c", "K10",
                                       "K11", "K14")))
    for where, shape, names in () if n24_only else main:
        for name in names:
            if name == "K11":
                if only is None or name in only:
                    for site, args in k11_cases(where, *shape):
                        yield name, site, args
                continue
            if only is None or name in only:
                yield name, where, operands(name, *shape,
                                            f32_input=name == "K7" and where in ("tiled", "real"))
                if name == "K9a":
                    yield name, f"{where}/raw", operands(name, *shape, raw=True)
    if (only is None or "K8" in only) and not n24_only:
        mask = band_mask(5, 32, 10, 11, torch.device(dev))  # EPIT's mask, L = 160
        for where, seqs in (("epit-tiled", 2 * 5 * 32), ("epit-train", 8 * 5 * 32)):
            yield "K8", where, (*(rn(seqs, 160, 2 * C, dt=dtype) for _ in range(3)), mask, HEADS)
        zero = torch.zeros(25, 25, device=dev)  # LFT's AngTrans: all 25 angular tokens
        yield "K8", "lft-ang", (*(rn(LFT_TILES * 32 * 32, 25, C, dt=dtype) for _ in range(3)),
                                zero, 8)
    if (only is None or "K12" in only) and not n24_only:
        yield "K12", "lft-tiled", (*(rn(LFT_TILES * 25, 32 * 32, 2 * C, dt=dtype)
                                     for _ in range(3)), 8, 32, 32, 5, 5)
    if (only is None or "K13" in only) and not n24_only:
        for where, shape, code in (  # AngTrans's code is float32, SpaTrans's the compute dtype
                ("lft-ang", (LFT_TILES * 32 * 32, 25, C), rn(1, 25, C)),
                ("lft-spa", (LFT_TILES * 25, 32 * 32, 2 * C), rn(1, 32 * 32, 2 * C, dt=dtype)),
                ("epit-tiled", (2 * 5 * 32, 160, 2 * C), None)):
            d = shape[-1]
            yield "K13", where, (rn(*shape, s=2.0, dt=dtype), 1 + rn(d, s=0.2), rn(d, s=0.1),
                                 code, dtype)
    if (only is None or "K15" in only) and not n24_only:
        for where, (B, Lq, Lk) in LF_DET_SITES.items():
            kv = rn(B, Lk, 2 * C, s=1.5, dt=dtype)
            yield "K15", where, (rn(B, Lq, C, s=1.5, dt=dtype), kv[..., :C], kv[..., C:],
                                 LF_DET_HEADS)
            del kv
    # d_state 24 (EfficientLFNetV7's default) at its widths (Di 90, dt rank
    # 5) on the batch-8 train step's scan length
    for name in N24_KERNELS:
        if only is None or name in only:
            yield name, "v7-n24", operands(name, 8, 160, 160, raw=name == "K9a", **N24_DIMS)


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
    if name == "K9a":  # per (b, t, channel): softplus (delta given before it), the
        # scan as K1's, the D skip; the two roundings are not counted
        N = args[2].shape[1]
        return nbytes, 0.0, float(x.numel() * ((6 if args[7] else 0) + 7 * N + 2))
    if name == "K10":  # per pixel: the products C x Cz and Cz x 9 rr (of y's dtype);
        # lrelu (a compare and a multiply) per z, the nine adds per output
        Cz, rr = args[2].shape[2], args[2].shape[3]
        P = x.numel() // x.shape[-1]
        return (nbytes, 2.0 * P * Cz * (x.shape[-1] + 9 * rr), float(P * (2 * Cz + 9 * rr)))
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
    if name == "K12":  # per token and window slot: q.k and p v per head; max, exp, sum
        B, L, D = x.shape
        slots = args[6] * args[7]
        return nbytes, 4.0 * B * L * slots * D, 4.0 * B * L * args[3] * slots
    if name == "K13":  # per element: the code's add, sum(s) and sum(s s), r gamma,
        # s - mean, the product and + beta
        return nbytes, 0.0, float(x.numel() * (7 + (args[3] is not None)))
    if name == "K11":  # per output: KK products and KK - 1 adds, and the bias add
        w, bias = args[1], args[4]
        kk = w.shape[-2] * w.shape[-1]
        return nbytes, 0.0, float(x.numel() * (2 * kk - 1 + (bias is not None)))
    if name == "K14":  # per output: K products, K - 1 adds, the bias add; SiLU's negation,
        # exp, add and division
        return nbytes, 0.0, float(x.numel() * (2 * args[1].shape[0] + 4))
    if name == "K15":  # q.k and p v per (query, key, head); one exp a score
        B, Lq, D = x.shape
        Lk = args[1].shape[1]
        return nbytes, 4.0 * B * Lq * Lk * D, float(B * args[3] * Lq * Lk)
    raise KeyError(name)


def bound(name: str, args, outs) -> tuple[float, str, float]:
    """The least time the card could take for this call: the larger of its
    bytes over HBM_BYTES_S and its operations over the peak for their type:
    matrix products on the tensor cores, of bf16 operands at
    BF16_TENSOR_FLOPS and of float32 ones at TF32_TENSOR_FLOPS (the rate
    a float32 product can reach there, as K6's 3xTF32 products do), the
    rest on the CUDA cores at F32_FLOPS. Returns (ms, what sets it, the
    CUDA-core floor in ms: all of the FLOPs as float32 on the CUDA cores)."""
    nbytes, mm, other = work(name, args, outs)
    # the products' operands: K7's weights (its float32-input mode multiplies
    # bf16 xn and rest by bf16 weights), else the first input's dtype
    mm_dtype = (args[3] if name == "K7" else args[0]).dtype
    mm_peak = BF16_TENSOR_FLOPS if mm_dtype == torch.bfloat16 else TF32_TENSOR_FLOPS
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


def sdpa_fastest(q, k, v, heads, want):
    """K15's function as one ``scaled_dot_product_attention`` call on each
    of its fused backends (flash, memory-efficient, cuDNN) that takes the
    call: the library yardstick. Returns (the fastest one's ms or None, a
    note naming each backend's ms and the fastest one's max|d| vs ``want``)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, Lq, D = q.shape
    split = lambda a: a.unflatten(-1, (heads, D // heads)).transpose(1, 2)
    qs, ks, vs = split(q), split(k), split(v)
    run = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    backends = {"flash": SDPBackend.FLASH_ATTENTION, "efficient": SDPBackend.EFFICIENT_ATTENTION,
                "cuDNN": SDPBackend.CUDNN_ATTENTION}
    times = {}
    for name, backend in backends.items():
        try:
            with sdpa_kernel([backend]):
                run()
                times[name] = time_ms(run)
        except RuntimeError:  # the backend does not take the call
            continue
    if not times:
        return None, ", scaled_dot_product_attention: no fused backend takes it"
    best = min(times, key=times.get)
    with sdpa_kernel([backends[best]]):
        err = (run().transpose(1, 2).reshape(B, Lq, D).float() - want.float()).abs().max().item()
    return times[best], (", scaled_dot_product_attention " +
                         ", ".join(f"{n} {t:.4f} ms" for n, t in times.items()) +
                         f" (fastest {best}, max|d| vs twin {err:.3e})")


def k15_against_formula(got, want, args, where: str) -> None:
    """K15's own check beside the shared bound: against the float32 formula
    on the same operands, bf16 within 2 bf16 ulps of its scale and no
    farther from it than the bf16 twin (``want``, which rounds the scores
    and P) plus one ulp; float32 within 1e-5 of the scale."""
    from lfsr_tpu_torch.ops.dense_attention import dot_product_attention

    q, k, v, heads = args
    bf16 = q.dtype == torch.bfloat16
    ref = dot_product_attention(q.float(), k.float(), v.float(), heads) if bf16 else want
    scale = max(1.0, ref.abs().max().item())
    err = (got.float() - ref).abs().max().item()
    ok = err <= (2 * 2.0**-8 if bf16 else 1e-5) * scale
    twin_err = (want.float() - ref).abs().max().item() if bf16 else 0.0
    if bf16:
        ok = ok and err <= twin_err + 2.0**-8 * scale
    log(f"[kernels] K15 {str(q.dtype)[6:]:8s} {where}: vs the float32 formula max|d| {err:.3e} "
        f"(scale {scale:.3f}" + (f"; the bf16 twin's {twin_err:.3e}" if bf16 else "") + f"): "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, f"K15 {where}: {err} from the float32 formula"


def layer_norm_call(x, gamma, beta, add, out_dtype):
    """A LayerNorm over x alone as one PyTorch call (``F.layer_norm``, its
    weights in x's dtype; the code's add not included): the library
    yardstick for K13."""
    from lfsr_tpu_torch.ops.cross_scan import EPS

    g, b = gamma.to(x.dtype), beta.to(x.dtype)
    return lambda: torch.nn.functional.layer_norm(x, (x.shape[-1],), g, b, EPS)


def conv2d_call(x, w, dilation, rounding, bias):
    """K11's "once" convolution as the one PyTorch call the flagship made
    before K11 (``F.conv2d``, cuDNN's grouped conv on the NHWC map), without
    the bias: the library yardstick."""
    (dh, dw), C = ((dilation, dilation) if isinstance(dilation, int) else dilation), x.shape[-1]
    pad = (dh * (w.shape[-2] - 1) // 2, dw * (w.shape[-1] - 1) // 2)
    xc, wc = x.permute(0, 3, 1, 2), w.to(x.dtype)
    return lambda: torch.nn.functional.conv2d(xc, wc, None, padding=pad, dilation=(dh, dw),
                                              groups=C)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 or bf16 tensor's raw bits (a signed zero differs from +0)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def k14_against_twin(got, want, where: str) -> None:
    """K14's own check beside the shared bound: the chain bit for bit."""
    same = torch.equal(bits(got), bits(want))
    log(f"[kernels] K14 {str(got.dtype)[6:]:8s} {where}: equals the chain bit for bit: {same}")
    assert same, f"K14 {where}: differs from the chain"


def k11_against_twin(got, want, args, where: str) -> None:
    """K11's own check beside the shared bound: "tap" equals the chain bit
    for bit; "once" lies within one ulp of the dtype of F.conv2d's, plus
    the float32 sums' own rounding in another order: (KK - 1) 2^-23 of the
    sum of |x w| (KK - 1 adds a side, each within 2^-24 of it)."""
    from lfsr_tpu_torch.ops import depthwise as dw

    if args[3] == "tap":
        same = torch.equal(bits(got), bits(want))
        log(f"[kernels] K11 {str(got.dtype)[6:]:8s} {where}: equals the chain bit for bit: {same}")
        assert same, f"K11 {where}: tap differs from the chain"
        return
    x, w, d, rounding, _ = args
    conv, ref = got.float(), want.float()
    kk = w.shape[-2] * w.shape[-1]
    slack = (kk - 1) * 2.0**-23 * dw.depthwise_plain(x.abs(), w.abs(), d, rounding).float()
    big = torch.maximum(conv.abs(), ref.abs())  # one ulp of the larger: frexp's m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(big),
                      torch.frexp(big).exponent - (8 if x.dtype == torch.bfloat16 else 24))
    diff = (conv - ref).abs()
    within = bool((diff <= ulp + slack).all())
    log(f"[kernels] K11 {str(x.dtype)[6:]:8s} {where}: the conv within one ulp of F.conv2d's: "
        f"{within} (max|d| {diff.max().item():.3e}, {(diff > 0).float().mean().item():.2e} of "
        f"values differ)")
    assert within, f"K11 {where}: once differs from F.conv2d by more than an ulp"


def timed_call(fn):
    """(fn(), its time in ms): one call between two CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def k1_passes(args, where: str) -> None:
    """K1's chunk-parallel scan at ``args``: its chunk length Tc and the
    time of each pass (the wrapper's launches, not counted)."""
    from lfsr_tpu_torch.ops import scan

    u = args[0]
    B, L, _ = u.shape
    tc = scan.scan_chunk_len(B, L)
    passes = scan.chunk_scan_passes(*args, torch.empty_like(u))
    times = {name: time_ms(launch, 10, 2) for name, launch in passes}
    log(f"[kernels] K1 {str(u.dtype)[6:]} {where} passes: Tc {tc} ({-(-L // tc)} chunks x B {B}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f" ({CARD})")


def k3_passes(args, where: str) -> None:
    """K3's chunk-parallel reverse scan at ``args``: its chunk count and the
    time of each pass (the wrapper's launches, not counted)."""
    from lfsr_tpu_torch.ops import scan

    u, A = args[0], args[5]
    B, L, Di = u.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=u.device)
    outs = (torch.empty(B, L, Di, **f32), torch.empty(B, L, Di, **f32),
            torch.empty(B, L, N, **f32), torch.empty(B, L, N, **f32), torch.empty(B, N, Di, **f32))
    passes = scan.adjoint_passes(*args, outs)
    times = {name: time_ms(launch, 10, 2) for name, launch in passes}
    log(f"[kernels] K3 {str(u.dtype)[6:]} {where} passes: chunk {scan.STATE_SPACING} "
        f"({-(-L // scan.STATE_SPACING)} chunks x B {B}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f" ({CARD})")


def check_kernels(results: dict, only=None, n24_only: bool = False) -> None:
    from lfsr_tpu_torch import trace
    from lfsr_tpu_torch.ops import _cuda, block, cross_scan as cs, dense_attention as da
    from lfsr_tpu_torch.ops import depthwise as dw, head
    from lfsr_tpu_torch.ops import local_attention as la, masked_attention as ma, scan
    from lfsr_tpu_torch.ops import window_attention as wa
    from lfsr_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain

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
        "K9a": (scan.selective_scan_fused, scan.selective_scan_fused_plain),
        "K9b": (scan.scan_gated_fused, scan.scan_gated_plain),
        "K9c": (scan.mamba_inner_fused, scan.mamba_inner_plain),
        "K10": (head.hlfr_tail, head.hlfr_tail_plain),
        "K11": (dw.depthwise_conv, dw.depthwise_plain),
        "K12": (la.local_window_mha, la.local_window_plain),
        "K13": (layer_norm, layer_norm_plain),
        "K14": (scan.conv_silu_fused, scan.conv_silu_plain),
        "K15": (da.dense_mha, da.dot_product_attention),
    }
    # the JSON line reports each kernel on its model's bf16 path (K6 runs
    # on the flagship's float32 residual stream): K1, K4-K7 and K10 at the
    # Synth whole-scene dispatch, the flagship's default eval, where all of
    # them run (K11 its 3x3 d 1 "tap" site there); K2 and K3 at the batch-8
    # train step; K9a at the train shape of its op phase, delta after
    # softplus; K8 at EPIT's default (tiled) eval; K12 at LFT's tiled call;
    # K13 at LFT's SpaTrans call; K15 at LF-DET's spatial site
    main = {k: (torch.float32 if k == "K6" else torch.bfloat16,
                "train" if k in ("K2", "K3", "K9a") else "epit-tiled" if k == "K8"
                else "synth/d1" if k == "K11" else "lft-tiled" if k == "K12"
                else "lft-spa" if k == "K13" else "lfdet-spa" if k == "K15" else "synth")
            for k in pairs}
    # the kernels with two paths: which one a call takes (each counted in
    # the trace table as launches/<K>/<path>)
    path_of = {
        "K4": lambda a: cs.gather_path(a[0].dtype, a[0].shape[-1]),
        "K5": lambda a: cs.kernel_path(a[1].dtype, a[1].shape[-1]),
        "K6": lambda a: wa.kernel_path(a[0].shape[-1], 4, 8),
        "K7": lambda a: block.kernel_path(a[3].dtype),
        "K8": lambda a: ma.kernel_path(a[0].dtype, a[0].shape[-1] // a[4]),
        "K11": lambda a: a[3],  # its rounding
        "K12": lambda a: la.kernel_path(a[0].dtype),
        "K14": lambda a: scan.conv_silu_path(a[0], a[0].stride(1)),
        "K15": lambda a: da.kernel_path(a[0].dtype),
    }
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    for dtype, tol in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for name, where, args in kernel_cases(dtype, g, only, n24_only):
            kern, plain = pairs[name]
            big = where in WHOLE and name in SCANS
            before = trace.counts(f"launches/{name}/")
            got = kern(*args)
            torch.cuda.synchronize()
            path = None
            if name in path_of:  # which of its two kernels took the call
                counts, path = trace.counts(f"launches/{name}/"), path_of[name](args)
                assert counts == {k: v + (k == path) for k, v in before.items()}, (name, counts)
                # the flagship's K4 takes its tile kernel, K14 its 16-byte
                # lanes; K6, and K5 and K7 in bf16, take the tensor cores
                assert (path == "tile" if name == "K4" else path == "vec" if name == "K14"
                        else path == "mma" or name in ("K8", "K11")
                        or (name != "K6" and dtype == torch.float32)), (name, dtype, path)
                log(f"[kernels] {name} {str(dtype)[6:]:8s} {where}: the {PATH_NAMES[path]} "
                    f"kernel ({path})" + (f", x {str(args[0].dtype)[6:]}" if name == "K7" else ""))
            if name == "K1" and dtype == torch.bfloat16:
                k1_passes(args, where)
            if name == "K3":
                k3_passes(args, where)
            if name == "K2":  # the training forward's y is K1's, bit for bit
                same = torch.equal(got[0], scan.selective_scan_proj(*args))
                log(f"[kernels] K2 {str(dtype)[6:]:8s} y == K1 y bit for bit: {same}")
                assert same, f"K2 {dtype}: y differs from K1's"
            want, plain_ms = timed_call(lambda: plain(*args))
            if name == "K11":  # "tap": the chain bit for bit; "once": within an ulp of cuDNN's
                k11_against_twin(got, want, args, where)
            if name == "K14":
                k14_against_twin(got, want, where)
            if name == "K15":  # and against the float32 formula
                k15_against_formula(got, want, args, where)
            # each output against its own scale (K3's dA sums over L, its du
            # does not); float32 outputs (K2's states, all of K3's) from
            # bf16 inputs are computed in float32 on both sides, K10's from
            # z rounded to bf16 on both sides (the bound of its inputs' dtype)
            outs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            errs = [_cuda.twin_error(a, b) for a, b in outs]
            bounds = [(tol if a.dtype == torch.bfloat16 or name == "K10" else F32_BOUND) * sc
                      for (a, _), (_, sc) in zip(outs, errs)]
            bound_ms, bound_by, core_ms = bound(name, args, [a for a, _ in outs])
            library_ms, lib_note = None, ""
            if name == "K11" and args[3] == "once":  # cuDNN's grouped conv, the old call
                library_ms = time_ms(conv2d_call(*args))
                lib_note = f", F.conv2d (cuDNN) {library_ms:.4f} ms"
            if name == "K13":  # one F.layer_norm of x alone, in x's dtype
                library_ms = time_ms(layer_norm_call(*args))
                lib_note = f", F.layer_norm (x alone) {library_ms:.4f} ms"
            if name == "K8":
                run, layout = sdpa_call(*args)
                lib_err = (layout(run()).float() - want.float()).abs().max().item()
                library_ms = time_ms(run)
                lib_note = (f", scaled_dot_product_attention {library_ms:.4f} ms "
                            f"(max|d| vs twin {lib_err:.3e})")
            if name == "K15":
                library_ms, lib_note = sdpa_fastest(*args, want)
            del got, want, outs
            err = max(e for e, _ in errs)
            ok = all(np.isfinite(e) and e <= b for (e, _), b in zip(errs, bounds))
            ms = time_ms(lambda: kern(*args), *((5, 1) if big else (20, 3)))
            if not big:
                plain_ms = time_ms(lambda: plain(*args), 5, 1)
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
                                 "library_ms": library_ms, **({"path": path} if path else {})}
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
    drop = ("K1", "K14") if impl == "fused" else ("K1",)  # K9c takes the conv + SiLU too
    out = {k: n for k, n in PER_FORWARD.items() if k.split()[0] not in drop}
    return {**out, SCAN_IMPL_KERNELS[impl]: PER_FORWARD["K1 selective_scan_proj"]}


def per_step(impl: str = "pallas") -> dict:
    """Launches per train step under ``scan_impl=impl``: K9b or K9c forward
    in the place of K2, and no K3 (their gradient is the twin's)."""
    if impl == "pallas":
        return PER_STEP
    out = {k: n for k, n in PER_STEP.items() if k.split()[0] not in ("K1", "K2", "K3")}
    return {**out, SCAN_IMPL_KERNELS[impl]: PER_STEP["K2 selective_scan_proj_states"]}


def eval_launches(forwards: int, impl: str = "pallas") -> dict:
    """Launches of ``forwards`` eval forwards (K2 and K3 do not run in
    eval; K7 runs on every map, in its float32-input mode below the TPU's
    gate)."""
    return {k: n * forwards for k, n in per_forward(impl).items()}


def k8_kernel(cfg):
    """The K8 kernel (``"mma"`` or ``"fma"``) that ``cfg``'s EPIT takes:
    by its compute dtype, at its head dim (128 channels, HEADS heads)."""
    from lfsr_tpu_torch.models.epit import HEADS
    from lfsr_tpu_torch.ops.masked_attention import kernel_path

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return kernel_path(dtype, 128 // HEADS)


def launch_counts() -> dict:
    """Each kernel's launches since the last :func:`reset_launch_counts`
    (``launches/<K>`` of the trace table), by its name in ``ops.KERNELS``."""
    from lfsr_tpu_torch import trace
    from lfsr_tpu_torch.ops import KERNELS

    return {name: trace.counter(f"launches/{name.split()[0]}") for name in KERNELS}


def reset_launch_counts() -> None:
    from lfsr_tpu_torch import trace

    trace.reset_counts("launches/")


def check_counts(counts: dict, want: dict, what: str, cfg=None) -> None:
    """Every kernel's launches == ``want`` (0 for a kernel it does not list);
    every K4 launch (the flagship's 64 channels, bf16 or float32) on its
    tile kernel; every K6 launch (the flagship's: 64 channels, 4 heads of
    16) on its tensor-core kernel; every K5 and K7 launch on its
    tensor-core kernel in bf16 (``cfg`` None: the flagship's default, bf16)
    and on its CUDA-core one in float32; for ``cfg``'s EPIT, every K8
    launch by the kernel ``k8_kernel`` names; for ``cfg``'s LFT, every K8
    launch (head dim 8) on its CUDA-core kernel and every K12 launch on the
    kernel of ``cfg``'s compute dtype; K13's launches with the code's add
    ``K13_CODE_SHARE`` of its launches (half of LFT's, none of EPIT's);
    every K14 launch (the flagship's Di 80) on its 16-byte lanes; for
    ``cfg``'s LF-DET, every K15 launch on the kernel of ``cfg``'s compute
    dtype and every K11 launch (its Mix-FFN convs) "once"."""
    from lfsr_tpu_torch import trace
    from lfsr_tpu_torch.ops import dense_attention, local_attention, masked_attention

    k4_paths, k5_paths, k6_paths, k7_paths, k8_paths, k12_paths = (
        trace.counts(f"launches/{k}/") for k in ("K4", "K5", "K6", "K7", "K8", "K12"))
    k13_code = trace.counter("launches/K13/code")
    for name, n in counts.items():
        assert n == want.get(name, 0), f"{what}: {name} {n} launches, expected {want.get(name, 0)}"
    log(f"[{what}] launches {counts}")
    k4 = counts["K4 cross_scan_gather"]
    assert k4_paths == {"tile": k4, "warp": 0}, (what, k4_paths, k4)
    k14, k14_paths = counts["K14 conv_silu_fused"], trace.counts("launches/K14/")
    assert k14_paths == {"vec": k14, "elem": 0}, (what, k14_paths, k14)
    if k14:
        log(f"[{what}] K14 launches by kernel {k14_paths}: all {k14} on 16-byte lanes")
    if k4:
        log(f"[{what}] K4 launches by kernel {k4_paths}: all {k4} on the tile kernel")
    bf16 = cfg is None or cfg.compute_dtype == "bfloat16"
    for name, paths in (("K5 cross_scan_scatter", k5_paths),
                        ("K7 ln_msl", k7_paths)):
        n = counts[name]
        assert paths == ({"mma": n, "fma": 0} if bf16 else {"mma": 0, "fma": n}), (
            what, name, paths, n)
        if n:
            log(f"[{what}] {name.split()[0]} launches by kernel {paths}: all {n} on the "
                f"{'tensor-core' if bf16 else 'CUDA-core'} kernel")
    k6 = counts["K6 window_mha_fused"]
    assert k6_paths == {"mma": k6, "fma": 0}, (what, k6_paths, k6)
    if k6:
        log(f"[{what}] K6 launches by kernel {k6_paths}: all {k6} on the tensor-core "
            f"kernel")
    k13 = counts["K13 layer_norm"]
    share = K13_CODE_SHARE.get(cfg.model_name, 0.0) if cfg is not None else 0.0
    assert k13_code == share * k13, (what, k13_code, k13)
    if k13:
        log(f"[{what}] K13 launches: {k13}, {k13_code} of them with the code's add")
    if cfg is not None and cfg.model_name == "EPIT":
        k8, path = counts["K8 masked_mha_fused"], k8_kernel(cfg)
        assert k8_paths[path] == k8 > 0, (k8_paths, k8)
        log(f"[{what}] K8 launches by kernel {k8_paths}: all {k8} on the "
            f"{'tensor-core' if path == 'mma' else 'CUDA-core'} kernel")
    if cfg is not None and cfg.model_name == "LFT":
        dtype = torch.bfloat16 if bf16 else torch.float32
        for name, paths, path in (
                ("K8 masked_mha_fused", k8_paths, masked_attention.kernel_path(dtype, 8)),
                ("K12 local_window_mha", k12_paths, local_attention.kernel_path(dtype))):
            n = counts[name]
            assert path == ("mma" if name.startswith("K12") and bf16 else "fma"), (name, path)
            assert paths[path] == n > 0 and sum(paths.values()) == n, (what, name, paths, n)
            log(f"[{what}] {name.split()[0]} launches by kernel {paths}: all {n} on the "
                f"{PATH_NAMES[path]} kernel")
    if cfg is not None and cfg.model_name == "LF_DET":
        path = dense_attention.kernel_path(torch.bfloat16 if bf16 else torch.float32)
        k15, k15_paths = counts["K15 dense_mha"], trace.counts("launches/K15/")
        assert k15_paths[path] == k15 > 0 and sum(k15_paths.values()) == k15, (what, k15_paths)
        k11, k11_paths = counts["K11 depthwise_conv"], trace.counts("launches/K11/")
        assert k11_paths == {"tap": 0, "once": k11}, (what, k11_paths, k11)
        log(f"[{what}] K15 launches by kernel {k15_paths}: all {k15} on the {PATH_NAMES[path]} "
            f"kernel; K11's {k11} all {PATH_NAMES['once']}")


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
    from lfsr_tpu_torch.ops import _cuda
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
    check_counts(counts, {k: n * dispatches for k, n in per_dispatch.items()}, what, cfg)
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
    launch counts per dispatch (K7 12 on both geometries), finite
    SR and metrics, ms/scene and peak memory. Returns the launches of both
    and, per geometry, (scene 0's SR views, ms/scene, peak GiB)."""
    from lfsr_tpu_torch.ops import KERNELS
    from lfsr_tpu_torch.train.evaluate import _whole_pad_batch, evaluate_sets

    ang, s, mb = cfg.angRes, cfg.scale_factor, cfg.whole_scene_minibatch
    assert len(synth) == len(real) == mb, "one dispatch per geometry"
    for subset, scenes in (("Synth", synth), ("Real", real)):  # warm-up, both geometries
        evaluate_sets(model, {subset: scenes}, cfg, log=lambda m: None)
    torch.cuda.synchronize()

    total = dict.fromkeys(KERNELS, 0)
    out = {}
    for subset, scenes in (("Synth", synth), ("Real", real)):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate_sets(model, {subset: scenes}, cfg, log=log, keep_views=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts(counts, eval_launches(1, impl), f"{what} {subset}")
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


def write_npz_tree(root: Path, tag: str, subsets: dict) -> None:
    """Write ``{dataset: [TestScene]}`` as the loaders' ``.npz`` tree
    ``root/tag/<dataset>/<scene>.npz`` (numpy only)."""
    for ds, scenes in subsets.items():
        d = root / tag / ds
        d.mkdir(parents=True, exist_ok=True)
        for sc in scenes:
            np.savez(d / f"{sc.name}.npz", Lr_SAI_y=sc.lr_y, Hr_SAI_y=sc.hr_y,
                     Sr_SAI_cbcr=sc.sr_cbcr)


@contextlib.contextmanager
def timing(owner, name: str, sink: list):
    """Within the block, ``owner.name`` is wrapped: each call appends its
    seconds (after a device synchronise) to ``sink``."""
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def state_gap(a, b) -> dict:
    """Where trainers ``a`` and ``b`` part: max|a - b| of the parameters and
    of both moments, and the number of the optimizer's counts and the step
    that differ."""
    from lfsr_tpu_torch.train.trainer import OPT_COUNTS

    sa, sb = a.opt_state, b.opt_state
    return {"param": max((a.params[k] - b.params[k]).abs().max().item() for k in a.params),
            "mu": (sa.mu_flat - sb.mu_flat).abs().max().item(),
            "nu": (sa.nu_flat - sb.nu_flat).abs().max().item(),
            "counts": sum(not torch.equal(getattr(sa, k), getattr(sb, k)) for k in OPT_COUNTS)
            + (a.step != b.step)}


def resume_control(cfg, spe: int, ckpt: Path, spoil):
    """A trainer restored from ``ckpt`` (epoch 0), spoiled by ``spoil``,
    then run through epoch 1 as ``scripts.train`` would."""
    from lfsr_tpu_torch.bridge import init_params
    from lfsr_tpu_torch.data.datasets import load_train_set
    from lfsr_tpu_torch.train.trainer import Trainer, restore_checkpoint

    data = load_train_set(cfg.path_for_train, cfg.angRes, cfg.scale_factor, cfg.data_name,
                          tag=cfg.task_tag())
    tr = Trainer(cfg, spe, init_params(cfg, torch.Generator().manual_seed(cfg.seed)),
                 device=DEVICE)
    assert restore_checkpoint(ckpt, tr) == 0
    spoil(tr.opt_state)
    tr.run_epoch(data, 1)
    return tr


def entry_train(flags: list, log_dir: Path, epochs: int, steps: int, dispatches: int) -> tuple:
    """``scripts.train.main`` of ``flags`` to ``epochs`` in ``log_dir``,
    between a count reset and read: launches == per step x ``steps`` + the
    validation's ``dispatches``. Returns (cfg, trainer, seconds, epoch
    seconds, checkpoint-save seconds)."""
    from lfsr_tpu_torch.cli import build_parser, config_from_args
    from lfsr_tpu_torch.scripts import train
    from lfsr_tpu_torch.train.trainer import Trainer

    cfg = config_from_args(build_parser().parse_args(
        [*flags, "--path_log", str(log_dir), "--epoch", str(epochs)]))
    epoch_s, save_s = [], []
    reset_launch_counts()
    t0 = time.perf_counter()
    with timing(Trainer, "run_epoch", epoch_s), timing(train, "save_checkpoint", save_s):
        tr = train.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = add({k: n * steps for k, n in PER_STEP.items()}, eval_launches(dispatches))
    check_counts(launch_counts(), want, f"entry train --epoch {epochs}")
    return cfg, tr, seconds, epoch_s, save_s


def run_entry(synth: list, real: list) -> dict:
    """The entry-point phase (module docstring, phase 6). Returns its
    launches, each run counted between its own reset and read."""
    from lfsr_tpu_torch.cli import build_parser, config_from_args
    from lfsr_tpu_torch.scripts import check_efficiency, inference, test, validate_submission
    from lfsr_tpu_torch.train.evaluate import evaluate_sets
    from lfsr_tpu_torch.train.trainer import latest_checkpoint, restore_checkpoint, save_checkpoint
    from lfsr_tpu_torch.utils import create_dirs

    t_phase = time.perf_counter()
    tag, mb = "SR_5x5_4x", 4
    n_val = (-(-EVAL_SCENES // mb)) * 2  # whole-scene dispatches of the 4 + 4 scenes
    totals = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = train_data(TRAIN_PATCHES)
        train_dir = tmp / "train" / tag / "Synthetic"
        train_dir.mkdir(parents=True)
        for i in range(len(data)):
            np.savez(train_dir / f"{i:06d}.npz", Lr_SAI_y=data.lr[i], Hr_SAI_y=data.hr[i])
        write_npz_tree(tmp / "test", tag, {"Real": real[:EVAL_SCENES], "Synth": synth[:EVAL_SCENES]})
        t0 = time.perf_counter()
        write_npz_tree(tmp / "submission_in", tag, {"Real": real, "Synth": synth})
        log(f"[entry] .npz trees written: {len(data)} training pairs, {EVAL_SCENES} + "
            f"{EVAL_SCENES} test scenes, {len(synth)} + {len(real)} submission scenes "
            f"({time.perf_counter() - t0:.1f} s for the latter)")
        flags = ["--batch_size", "8", "--warmup_epochs", "2", "--seed", str(SEED),
                 "--path_for_train", str(tmp / "train"), "--path_for_test", str(tmp / "test")]
        spe = TRAIN_PATCHES // 8

        # train: 1 epoch, then 2 (resuming), and 2 straight in another log dir
        runs = {}
        for name, epochs in (("resumed", (1, 2)), ("straight", (2,))):
            done = 0
            for e in epochs:
                cfg, tr, secs, epoch_s, save_s = entry_train(flags, tmp / name, e,
                                                             spe * (e - done), n_val)
                totals.append(launch_counts())
                log(f"[entry train] {name} --epoch {e}: {spe * (e - done)} steps + validation "
                    f"in {secs:.1f} s; epochs {', '.join(f'{x:.3f}' for x in epoch_s)} s = "
                    f"{', '.join(f'{1e3 * x / spe:.1f}' for x in epoch_s)} ms/step; checkpoint "
                    f"save {', '.join(f'{x:.3f}' for x in save_s)} s ({CARD})")
                done = e
            runs[name] = (cfg, tr)
        (cfg, resumed), (_, straight) = runs["resumed"], runs["straight"]
        ckpt_dir = create_dirs(cfg)[1]
        ckpts = sorted(ckpt_dir.iterdir())
        assert [c.name for c in ckpts] == ["epoch_0000.pt", "epoch_0001.pt"], ckpts
        assert resumed.step == straight.step == 2 * spe
        gap = state_gap(resumed, straight)
        log(f"[entry train] resumed vs straight after {2 * spe} steps: max|d| param "
            f"{gap['param']:.3e}, mu {gap['mu']:.3e}, nu {gap['nu']:.3e}; counts/step that "
            f"differ {gap['counts']} (all must be 0); checkpoints "
            f"{', '.join(f'{c.name} {c.stat().st_size / 2**20:.2f} MiB' for c in ckpts)}")
        assert not any(gap.values()), gap
        controls = {
            "moments zeroed": lambda st: (st.mu_flat.zero_(), st.nu_flat.zero_()),
            "counts reset": lambda st: st.count.zero_(),
        }
        for what, spoil in controls.items():
            ctl = resume_control(cfg, spe, ckpts[0], spoil)
            cgap = state_gap(ctl, straight)
            log(f"[entry train] control, epoch_0000.pt restored with the {what}, then epoch 1, "
                f"vs straight: max|d| param {cgap['param']:.3e}, mu {cgap['mu']:.3e}, nu "
                f"{cgap['nu']:.3e}; counts/step that differ {cgap['counts']} (must not all be 0)")
            assert any(cgap.values()), (what, cgap)
            del ctl
        t0 = time.perf_counter()
        save_checkpoint(tmp, resumed, 99)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_checkpoint(tmp / "epoch_0099.pt", straight)
        torch.cuda.synchronize()
        log(f"[entry train] checkpoint save {t_save:.3f} s, restore {time.perf_counter() - t0:.3f} "
            f"s ({CARD})")
        del straight, runs

        # test on the 8 scenes with the resumed checkpoint: one dispatch a scene
        reset_launch_counts()
        t0 = time.perf_counter()
        test.main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        totals.append(launch_counts())
        check_counts(totals[-1], eval_launches(2 * EVAL_SCENES), "entry test")
        results = create_dirs(cfg)[2]
        with open(results / "evaluation.csv") as f:
            rows = [line.rstrip("\n") for line in f]
        model, path = test.load_model(cfg, ckpt_dir, None, lambda m: None, DEVICE)
        assert path == latest_checkpoint(ckpt_dir) == ckpts[-1]
        scenes = {"Real": real[:EVAL_SCENES], "Synth": synth[:EVAL_SCENES]}
        want = evaluate_sets(model, scenes, cfg.replace(whole_scene_minibatch=1), log=lambda m: None)
        expect = ["Datasets,Scenes,PSNR,SSIM"] + [
            f"{ds},{n},{p:.6f},{s:.6f}" for ds, r in want.items()
            for n, p, s in [*r["scenes"], ("average", r["psnr"], r["ssim"])]]
        assert rows == expect, (rows, expect)
        n_bmp = len(list(results.rglob("*.bmp")))
        assert n_bmp == 2 * EVAL_SCENES * 25, n_bmp
        log(f"[entry test] {2 * EVAL_SCENES} scenes in {secs:.1f} s (with {n_bmp} BMPs); "
            f"evaluation.csv equals evaluate_sets' ({CARD})")
        del model

        # inference on the 16 + 16 scenes: gate, BMP tree, zip, validator
        scfg = cfg.replace(path_for_test=str(tmp / "submission_in"))
        dispatches = -(-len(synth) // mb) + -(-len(real) // mb)
        reset_launch_counts()
        t0 = time.perf_counter()
        zip_path = inference.main(scfg, out_root=str(tmp / "submission"), device=DEVICE)
        secs = time.perf_counter() - t0
        totals.append(launch_counts())
        check_counts(totals[-1], eval_launches(dispatches), "entry inference")
        assert zip_path == tmp / "submission.zip" and zip_path.exists(), zip_path
        assert validate_submission.main([str(zip_path)]) == 0
        log(f"[entry inference] gate + {len(synth)} Synth + {len(real)} Real scenes ({dispatches} "
            f"dispatches) -> BMP tree + {zip_path.stat().st_size / 2**20:.1f} MiB zip in "
            f"{secs:.1f} s; VALID ({CARD})")

    # the gate with its bench on the card
    reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = check_efficiency.main(["--bench", "--json"], device=DEVICE)
    totals.append(launch_counts())
    check_counts(totals[-1], eval_launches(GATE_FORWARDS), "entry check_efficiency --bench")
    r = json.loads(out.getvalue())
    assert rc == 0 and r["verdict"], r
    assert (r["params"], r["official_fvcore_macs"]) == (GATE_PARAMS, GATE_MACS), r
    lat, mem = r["latency"], r["memory"]
    log(f"[entry check_efficiency] params {r['params']:,}, official MACs "
        f"{r['official_fvcore_macs']:,}, {r['verdict'] and 'PASS'}; [1, 160, 160, 1]: latency "
        f"{lat['latency_ms']:.3f} ms/call, queued {lat['throughput_ms']:.3f} ms "
        f"({lat['throughput_per_s']:.1f} patches/s), peak memory "
        f"{mem['peak_bytes_in_use'] / 2**20:.1f} MiB ({CARD})")
    log(f"[entry] phase {time.perf_counter() - t_phase:.1f} s")
    return add(*totals)


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
    from lfsr_tpu_torch.ops import _cuda
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
            check_counts(counts, per_step, f"{what} grad check, kernels", cfg)
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
    check_counts(counts, {k: n * TRAIN_STEPS for k, n in per_step.items()}, what, cfg)
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


def run_k9a_op() -> dict:
    """K9a's path: the op ``selective_scan_fused`` at the train scan shape
    [8, 25600, 80] (delta before softplus, B and C slices of a dbc, D
    given), float32, its forward and one backward of sum(y^2) (the gradient
    of the chunked scan, D inside, as JAX's custom_vjp), on the kernel and
    on the plain twin (``_cuda.force_plain``): y within F32_BOUND and each
    gradient within GRAD_BOUND of the twin's. Returns the kernel run's
    launches."""
    from lfsr_tpu_torch.ops import _cuda, scan

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    B, L, Di, N, R = 8, 25600, 80, 16, 4
    rn = lambda *shape, s: torch.randn(*shape, generator=g, device=DEVICE) * s
    dbc = rn(B, L, R + 2 * N, s=0.5)
    args = (rn(B, L, Di, s=0.5), rn(B, L, Di, s=0.5),
            -torch.arange(1, N + 1, dtype=torch.float32, device=DEVICE).repeat(Di, 1),
            dbc[..., R : R + N], dbc[..., R + N :], 1 + rn(Di, s=0.1))
    runs = []
    for plain in (False, True):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        reset_launch_counts()
        with _cuda.force_plain() if plain else contextlib.nullcontext():
            y, fwd_ms = timed_call(lambda: scan.selective_scan_fused(*leaves, 256, True))
            grads, bwd_ms = timed_call(lambda: torch.autograd.grad((y**2).sum(), leaves))
        runs.append((y.detach(), grads, fwd_ms, bwd_ms, launch_counts()))
    (y, grads, fwd_ms, bwd_ms, counts), (py, pgrads, pfwd_ms, pbwd_ms, pcounts) = runs
    check_counts(counts, {"K9a selective_scan_fused": 1}, "K9a op, kernel")
    assert not any(pcounts.values()), pcounts
    err, scale = _cuda.twin_error(y, py)
    assert err <= F32_BOUND * scale, (err, scale)
    gerrs = [_cuda.twin_error(a, b) for a, b in zip(grads, pgrads)]
    for (e, sc), name in zip(gerrs, ("u", "delta", "A", "B", "C", "D")):
        assert np.isfinite(e) and e <= GRAD_BOUND * sc, (name, e, sc)
    log(f"[K9a op] selective_scan_fused float32 {tuple(args[0].shape)}, pre_softplus, D: "
        f"y max|d| {err:.3e} (bound {F32_BOUND} x {scale:.3f}); gradients of u, delta, A, B, "
        f"C, D max|d| / max(1, max|g|) "
        f"{', '.join(f'{e / sc:.3e}' for e, sc in gerrs)} (bound {GRAD_BOUND}) | kernel forward "
        f"{fwd_ms:.2f} ms + backward {bwd_ms:.2f} ms; twin {pfwd_ms:.2f} + {pbwd_ms:.2f} ms "
        f"({CARD})")
    del runs, grads, pgrads
    torch.cuda.empty_cache()
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
    whole-scene and entry-point phases (the first EVAL_SCENES of each are
    the whole-scene phases' and the entry phase's validation and test)."""
    rng = np.random.default_rng(SEED + 1)
    synth = [make_scene(rng, f"synth{i:02d}", SYNTH_HR) for i in range(SUBMISSION_SCENES)]
    real = [make_scene(rng, f"real{i:02d}", REAL_HR) for i in range(SUBMISSION_SCENES)]
    return synth, real


def run_flagship(profile: bool = False, eval_paths: bool = True) -> dict:
    """The flagship's paths: train, tiled, whole-scene (under each
    ``scan_impl``), the entry points (train, resume, test, the submission
    through ``scripts.inference``, the gate). Returns the launches of their timed runs,
    each counted between its own reset and read."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import whole_scene_default

    cfg = Config()
    assert whole_scene_default(cfg), "the flagship's default eval is whole-scene"
    model, sd = seeded_model(cfg, 693_998)
    launches = [run_train(sd, Config(batch_size=8), PER_STEP, profile, "train")]
    lap("train")
    for impl in SCAN_IMPL_KERNELS:
        launches.append(run_train(sd, Config(batch_size=8, model_kwargs={"scan_impl": impl}),
                                  per_step(impl), False, f"{impl} train"))
        lap(f"{impl} train")
    if not eval_paths:
        return add(*launches)
    if profile:
        profile_tiled_dispatch(model, cfg)
    tiled = run_tiled(model, Config(whole_scene_for_test=False), eval_launches(1))
    lap("tiled")

    synth, real = flagship_scenes()
    whole, ref = run_whole(model, synth[:EVAL_SCENES], real[:EVAL_SCENES], profile)
    lap("whole")
    impls = []
    for impl in SCAN_IMPL_KERNELS:
        impls.append(run_scan_impl(impl, sd, synth[:EVAL_SCENES], real[:EVAL_SCENES], ref,
                                   profile))
        lap(f"{impl} whole")
    entry = run_entry(synth, real)
    lap("entry points")
    return add(*launches, tiled, whole, *impls, entry)


def run_scan_impl_alone(impl: str, profile: bool = False) -> dict:
    """``--scan-impl``: the 'pallas' model's whole-scene dispatches (the
    reference, counted and timed but not held against the twins), then
    ``run_scan_impl`` and the impl's train phase. Returns the launches of
    the latter two."""
    from lfsr_tpu_torch.config import Config

    model, sd = seeded_model(Config(), 693_998)
    synth, real = (sc[:EVAL_SCENES] for sc in flagship_scenes())
    ref = whole_dispatches(model, Config(), synth, real, "whole")[1]
    del model
    torch.cuda.empty_cache()
    whole = run_scan_impl(impl, sd, synth, real, ref, profile)
    train = run_train(sd, Config(batch_size=8, model_kwargs={"scan_impl": impl}), per_step(impl),
                      False, f"{impl} train")
    return add(whole, train)


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


def run_lft(profile: bool = False, eval_paths: bool = True) -> dict:
    """LFT's paths: its default tiled eval at the cell's 16 tiles a call
    and its batch-8 train step. Returns their launches."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import whole_scene_default

    cfg = Config(model_name="LFT", minibatch_for_test=LFT_TILES)
    assert not whole_scene_default(cfg), "LFT's default eval is tiled"
    assert (cfg.patch_size_for_test, cfg.stride_for_test) == (32, 16), cfg
    model, sd = seeded_model(cfg, LFT_PARAMS)
    runs = []
    if eval_paths:
        if profile:
            profile_tiled_dispatch(model, cfg)
        runs.append(run_tiled(model, cfg, LFT_PER_FORWARD, "lft tiled"))
    del model
    torch.cuda.empty_cache()
    runs.append(run_train(sd, cfg.replace(batch_size=8), LFT_PER_FORWARD, profile, "lft train"))
    return add(*runs)


def run_lfdet(profile: bool = False, eval_paths: bool = True) -> dict:
    """LF-DET's paths: its default tiled eval at the cell's 16 tiles a call
    and its batch-8 train step. Returns their launches."""
    from lfsr_tpu_torch.config import Config
    from lfsr_tpu_torch.models.registry import whole_scene_default

    cfg = Config(model_name="LF_DET", minibatch_for_test=LFT_TILES)
    assert not whole_scene_default(cfg), "LF-DET's default eval is tiled"
    assert (cfg.patch_size_for_test, cfg.stride_for_test) == (32, 16), cfg
    model, sd = seeded_model(cfg, LF_DET_PARAMS)
    runs = []
    if eval_paths:
        if profile:
            profile_tiled_dispatch(model, cfg)
        runs.append(run_tiled(model, cfg, LF_DET_PER_FORWARD, "lfdet tiled"))
    del model
    torch.cuda.empty_cache()
    runs.append(run_train(sd, cfg.replace(batch_size=8), LF_DET_PER_FORWARD, profile,
                          "lfdet train"))
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
                    help="after the kernel phase run the training phases (every scan_impl's "
                         "for the flagship) and K9a's op only (no eval paths)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--model", choices=("LFMambaX", "EPIT", "LFT", "LF_DET"),
                      help="only this model's kernels and phases (default: all)")
    only.add_argument("--scan-impl", choices=tuple(SCAN_IMPL_KERNELS),
                      help="only the flagship's kernel of this scan_impl (K9b or K9c), its "
                           "whole-scene eval phase, beside the 'pallas' dispatches it is held "
                           "against, and its train phase")
    only.add_argument("--entry-only", action="store_true",
                      help="only the flagship's kernels against their twins and the "
                           "entry-point phase (train, resume, test, inference, the gate)")
    only.add_argument("--d-state-24", action="store_true",
                      help="only the scans at d_state 24 (K1-K3, K9a-K9c at [8, 25600, 90], "
                           "dt rank 5) against their twins, then stop")
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

    names = {"LFMambaX": ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K9a", "K9b", "K9c", "K10",
                          "K11", "K14"),
             "EPIT": ("K8", "K13"), "LFT": ("K8", "K12", "K13"), "LF_DET": ("K15",),
             None: None}[args.model]
    if args.scan_impl:
        names = (SCAN_IMPL_KERNELS[args.scan_impl].split()[0],)
    if args.entry_only:
        names = ENTRY_KERNELS
    results: dict = {}
    check_kernels(results, N24_KERNELS if args.d_state_24 else names, args.d_state_24)
    lap("kernels")
    if args.kernels_only or args.d_state_24:
        log(CARD)
        return 0
    eval_paths = not args.train_only
    runs = []
    if args.scan_impl:
        eval_paths = True
        runs.append(run_scan_impl_alone(args.scan_impl, profile=args.profile))
    if args.entry_only:
        eval_paths = True
        runs.append(run_entry(*flagship_scenes()))
        lap("entry points")
    elif args.model in (None, "LFMambaX") and not args.scan_impl:
        runs.append(run_flagship(profile=args.profile, eval_paths=eval_paths))
        runs.append(run_k9a_op())
        lap("K9a op")
    if args.model in (None, "EPIT") and not (args.scan_impl or args.entry_only):
        runs.append(run_epit(profile=args.profile, eval_paths=eval_paths))
        lap("EPIT")
    if args.model in (None, "LFT") and not (args.scan_impl or args.entry_only):
        runs.append(run_lft(profile=args.profile, eval_paths=eval_paths))
        lap("LFT")
    if args.model in (None, "LF_DET") and not (args.scan_impl or args.entry_only):
        runs.append(run_lfdet(profile=args.profile, eval_paths=eval_paths))
        lap("LF-DET")
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

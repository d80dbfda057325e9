"""Ops of the port: layouts, resize, tiling, metrics, and the kernels.

Each hand-written Hopper kernel has a wrapper (kernel on CUDA tensors,
plain twin on CPU tensors) with a launch counter. ``KERNELS`` lists them
with their sources and the TPU kernels they replace.
"""

from __future__ import annotations

from lfsr_tpu_torch.ops.cross_scan import cross_scan_gather, cross_scan_scatter
from lfsr_tpu_torch.ops.scan import selective_scan_proj
from lfsr_tpu_torch.ops.window_attention import window_mha_fused

# name -> (wrapper, CUDA source, TPU kernel it replaces)
KERNELS = {
    "K1 selective_scan_proj": (
        selective_scan_proj, "lfsr_tpu_torch/csrc/scan.cu",
        "lfsr_tpu/ops/pallas_scan.py:251",
    ),
    "K4 cross_scan_gather": (
        cross_scan_gather, "lfsr_tpu_torch/csrc/cross_scan.cu",
        "lfsr_tpu/ops/pallas_layout.py:288",
    ),
    "K5 cross_scan_scatter": (
        cross_scan_scatter, "lfsr_tpu_torch/csrc/cross_scan.cu",
        "lfsr_tpu/ops/pallas_layout.py:417",
    ),
    "K6 window_mha_fused": (
        window_mha_fused, "lfsr_tpu_torch/csrc/window_attention.cu",
        "lfsr_tpu/ops/pallas_attention.py:134",
    ),
}


def reset_launch_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}

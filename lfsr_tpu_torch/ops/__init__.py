"""Ops of the port: layouts, resize, tiling, metrics, and the kernels.

Each hand-written Hopper kernel has a wrapper (kernel on CUDA tensors,
plain twin on CPU tensors) with a launch counter; K2 and K3 run inside the
scan's autograd Function (``scan.ScanProj``) and K4-K8, K9b and K9c inside
``_cuda.PlainVJP`` when a gradient is wanted. ``KERNELS`` lists them
with their sources and the TPU kernels they replace.
"""

from __future__ import annotations

from lfsr_tpu_torch.ops.block import ln_msl
from lfsr_tpu_torch.ops.cross_scan import cross_scan_gather, cross_scan_scatter
from lfsr_tpu_torch.ops.masked_attention import masked_mha_fused
from lfsr_tpu_torch.ops.scan import (
    mamba_inner_fused, scan_gated_fused, selective_scan_proj, selective_scan_proj_bwd,
    selective_scan_proj_states,
)
from lfsr_tpu_torch.ops.window_attention import window_mha_fused

# name -> (wrapper, CUDA source, TPU kernel it replaces)
KERNELS = {
    "K1 selective_scan_proj": (
        selective_scan_proj, "lfsr_tpu_torch/csrc/scan.cu",
        "lfsr_tpu/ops/pallas_scan.py:251",
    ),
    "K2 selective_scan_proj_states": (
        selective_scan_proj_states, "lfsr_tpu_torch/csrc/scan.cu",
        "lfsr_tpu/ops/pallas_scan.py:1009",
    ),
    "K3 selective_scan_proj_bwd": (
        selective_scan_proj_bwd, "lfsr_tpu_torch/csrc/scan.cu",
        "lfsr_tpu/ops/pallas_scan.py:1135",
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
    "K7 ln_msl": (
        ln_msl, "lfsr_tpu_torch/csrc/ln_msl.cu", "lfsr_tpu/ops/pallas_block.py:220",
    ),
    "K8 masked_mha_fused": (
        masked_mha_fused, "lfsr_tpu_torch/csrc/masked_attention.cu",
        "lfsr_tpu/ops/pallas_masked_attention.py:86",
    ),
    "K9b scan_gated_fused": (
        scan_gated_fused, "lfsr_tpu_torch/csrc/mamba_inner.cu",
        "lfsr_tpu/ops/pallas_scan.py:444",
    ),
    "K9c mamba_inner_fused": (
        mamba_inner_fused, "lfsr_tpu_torch/csrc/mamba_inner.cu",
        "lfsr_tpu/ops/pallas_scan.py:747",
    ),
}


def reset_launch_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}

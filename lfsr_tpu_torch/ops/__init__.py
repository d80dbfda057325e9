"""Ops of the port: layouts, resize, tiling, metrics, and the kernels.

Each hand-written Hopper kernel has a wrapper (kernel on CUDA tensors,
plain twin on CPU tensors) with a launch counter; K2 and K3 run inside the
scan's autograd Function (``scan.ScanProj``) and K4-K8, K9a-K9c and K10
inside ``_cuda.PlainVJP`` when a gradient is wanted. ``KERNELS`` lists them
with their sources and the TPU kernels they replace; K8's ``PATH_LAUNCHES``
and K5's, K6's and K7's ``K5_PATH_LAUNCHES``, ``K6_PATH_LAUNCHES`` and
``K7_PATH_LAUNCHES`` split their launches between each one's tensor-core
(``"mma"``) and CUDA-core (``"fma"``) kernels; K4's ``K4_PATH_LAUNCHES``
between its tile kernel (``"tile"``) and its one-warp kernel (``"warp"``).
"""

from __future__ import annotations

from lfsr_tpu_torch.ops.block import PATH_LAUNCHES as K7_PATH_LAUNCHES
from lfsr_tpu_torch.ops.block import ln_msl
from lfsr_tpu_torch.ops.cross_scan import GATHER_PATH_LAUNCHES as K4_PATH_LAUNCHES
from lfsr_tpu_torch.ops.cross_scan import PATH_LAUNCHES as K5_PATH_LAUNCHES
from lfsr_tpu_torch.ops.cross_scan import cross_scan_gather, cross_scan_scatter
from lfsr_tpu_torch.ops.head import hlfr_tail
from lfsr_tpu_torch.ops.masked_attention import PATH_LAUNCHES, masked_mha_fused
from lfsr_tpu_torch.ops.scan import (
    mamba_inner_fused, scan_gated_fused, selective_scan_fused, selective_scan_proj,
    selective_scan_proj_bwd, selective_scan_proj_states,
)
from lfsr_tpu_torch.ops.window_attention import PATH_LAUNCHES as K6_PATH_LAUNCHES
from lfsr_tpu_torch.ops.window_attention import window_mha_fused

# name -> (wrapper, CUDA source, TPU kernel it replaces)
KERNELS = {
    "K1 selective_scan_proj": (
        selective_scan_proj, "lfsr_tpu_torch/csrc/scan_chunked.cu",
        "lfsr_tpu/ops/pallas_scan.py:251",
    ),
    "K2 selective_scan_proj_states": (
        selective_scan_proj_states, "lfsr_tpu_torch/csrc/scan_chunked.cu",
        "lfsr_tpu/ops/pallas_scan.py:1009",
    ),
    "K3 selective_scan_proj_bwd": (
        selective_scan_proj_bwd, "lfsr_tpu_torch/csrc/scan_adjoint.cu",
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
    "K9a selective_scan_fused": (
        selective_scan_fused, "lfsr_tpu_torch/csrc/scan.cu",
        "lfsr_tpu/ops/pallas_scan.py:557",
    ),
    "K9b scan_gated_fused": (
        scan_gated_fused, "lfsr_tpu_torch/csrc/mamba_inner.cu",
        "lfsr_tpu/ops/pallas_scan.py:444",
    ),
    "K9c mamba_inner_fused": (
        mamba_inner_fused, "lfsr_tpu_torch/csrc/mamba_inner.cu",
        "lfsr_tpu/ops/pallas_scan.py:747",
    ),
    "K10 hlfr_tail": (
        hlfr_tail, "lfsr_tpu_torch/csrc/hlfr_tail.cu", "lfsr_tpu/ops/pallas_head.py:151",
    ),
}


def reset_launch_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    # K8's, K4's, K5's, K6's and K7's per-kernel counts
    for counts in (PATH_LAUNCHES, K4_PATH_LAUNCHES, K5_PATH_LAUNCHES, K6_PATH_LAUNCHES,
                   K7_PATH_LAUNCHES):
        for path in counts:
            counts[path] = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}

"""Ops of the port: layouts, resize, tiling, metrics, and the kernels.

Each hand-written Hopper kernel has a wrapper (kernel on CUDA tensors,
plain twin on CPU tensors) that runs in its span (``trace.span("K1")`` ...)
and counts its launches in the trace table (``launches/K1`` ...;
``_cuda.counted``); K2 and K3 run inside the scan's autograd Function
(``scan.ScanProj``) and K4-K8, K9a-K9c, K10 and K11 inside
``_cuda.PlainVJP`` when a gradient is wanted. ``KERNELS`` lists them with
their sources and the TPU kernels they replace. K5's, K6's, K7's and K8's counters
``launches/<K>/mma`` and ``launches/<K>/fma`` split their launches between
each one's tensor-core and CUDA-core kernels; K4's ``launches/K4/tile``
and ``launches/K4/warp`` between its tile kernel and its one-warp kernel;
K11's ``launches/K11/tap`` and ``launches/K11/once`` between its two
roundings. K12 (LFT's banded spatial attention, ``local_window_mha``)
counts ``launches/K12``, split as ``launches/K12/mma`` (bfloat16, tensor
cores) and ``launches/K12/fma`` (float32, CUDA cores), and runs inside
``_cuda.PlainVJP`` when a gradient is wanted. K13 (LFT's and EPIT's
LayerNorms, ``layer_norm``) folds the add of a position code before the
LayerNorm into the same kernel; it counts ``launches/K13``, and
``launches/K13/code`` for the launches that fold in an addend (8 of LFT's
16 a forward), and runs inside ``_cuda.PlainVJP`` when a gradient is wanted.
K14 (the Mamba's causal conv + SiLU, ``scan.conv_silu_fused``, 12 a flagship
forward under ``'pallas'`` and ``'gated'``) counts ``launches/K14``, split as
``launches/K14/vec`` (16-byte lanes of channels) and ``launches/K14/elem``
(one channel a lane), and runs inside ``_cuda.PlainVJP`` when a gradient is
wanted. K15 (LF-DET's attentions with no mask, ``dense_mha``, 20 a forward)
counts ``launches/K15``, split as ``launches/K15/mma`` (bfloat16 with head
dim 16, tensor cores) and ``launches/K15/fma`` (CUDA cores), and runs inside
``_cuda.PlainVJP`` when a gradient is wanted. K11-K15 replace no TPU kernel:
JAX runs their ops as XLA ops.
"""

from __future__ import annotations

from lfsr_tpu_torch.ops.block import ln_msl
from lfsr_tpu_torch.ops.cross_scan import cross_scan_gather, cross_scan_scatter
from lfsr_tpu_torch.ops.dense_attention import dense_mha
from lfsr_tpu_torch.ops.depthwise import depthwise_conv
from lfsr_tpu_torch.ops.head import hlfr_tail
from lfsr_tpu_torch.ops.layer_norm import layer_norm
from lfsr_tpu_torch.ops.local_attention import local_window_mha
from lfsr_tpu_torch.ops.masked_attention import masked_mha_fused
from lfsr_tpu_torch.ops.scan import (
    conv_silu_fused, mamba_inner_fused, scan_gated_fused, selective_scan_fused, selective_scan_proj,
    selective_scan_proj_bwd, selective_scan_proj_states,
)
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
    "K11 depthwise_conv": (
        depthwise_conv, "lfsr_tpu_torch/csrc/depthwise.cu",
        "none: JAX runs _dw_apply (lfsr_tpu/models/lfmambax.py:57) as XLA-fused elementwise "
        "ops and LSFL's EPI convs as XLA grouped convs",
    ),
    "K12 local_window_mha": (
        local_window_mha, "lfsr_tpu_torch/csrc/local_attention.cu",
        "none: JAX runs local_window_mha (lfsr_tpu/ops/local_attention.py) as XLA ops",
    ),
    "K13 layer_norm": (
        layer_norm, "lfsr_tpu_torch/csrc/layer_norm.cu",
        "none: JAX runs flax's LayerNorm (and the add of the position code before it) as XLA ops",
    ),
    "K14 conv_silu_fused": (
        conv_silu_fused, "lfsr_tpu_torch/csrc/conv_silu.cu",
        "none: JAX runs Mamba._conv_silu (lfsr_tpu/models/ssm.py) as XLA elementwise ops",
    ),
    "K15 dense_mha": (
        dense_mha, "lfsr_tpu_torch/csrc/dense_attention.cu",
        "none: JAX runs flax's dot_product_attention (lfsr_tpu/models/lf_det.py) as XLA ops",
    ),
}


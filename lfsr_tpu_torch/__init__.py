"""lfsr_tpu_torch — PyTorch + CUDA port of ``lfsr_tpu`` for NVIDIA Hopper.

The JAX package ``lfsr_tpu`` is the reference; this package mirrors its
module names so every counterpart is easy to find:

- ``ops``    — layouts, bicubic residual, tiling, PSNR/SSIM, and the
  hand-written Hopper kernels (``scan``, ``cross_scan``,
  ``window_attention``) that replace the TPU Pallas kernels, each with its
  plain PyTorch twin in the same module;
- ``models`` — the flagship ``LFMambaX`` as ``nn.Module``s;
- ``train``  — tiled evaluation (``evaluate_sets``);
- ``bridge`` — flax param tree -> ``state_dict``, and a seeded random init.

Public functions keep the JAX layouts: NHWC activations and ``[B, L, C]``
sequences. The package imports ``torch`` and never ``jax``; from
``lfsr_tpu`` it uses only the jax-free ``config`` module.
"""

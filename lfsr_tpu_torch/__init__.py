"""lfsr_tpu_torch — PyTorch + CUDA port of ``lfsr_tpu`` for NVIDIA Hopper.

The JAX package ``lfsr_tpu`` is the reference; this package mirrors its
module names so every counterpart is easy to find:

- ``ops``    — layouts, bicubic residual, tiling, PSNR/SSIM, YCbCr->RGB,
  and the hand-written Hopper kernels (``scan``, ``cross_scan``,
  ``window_attention``, ``block``, ``masked_attention``) that replace the
  TPU Pallas kernels, each with its plain PyTorch twin in the same module
  and an autograd Function for training;
- ``models`` — the flagship ``LFMambaX`` and ``EPIT`` as ``nn.Module``s,
  with their losses;
- ``train``  — whole-scene and tiled evaluation (``evaluate_sets``) and
  training (``Trainer``: the train step, the optimizer, masking);
- ``inference`` — the NTIRE submission writer (``infer_submission``), with
  ``tools`` (the BMP codec, the submission packager and validator);
- ``bridge`` — flax param tree -> ``state_dict``, and a seeded random init;
- ``scripts`` — the command-line entry points (``python -m
  lfsr_tpu_torch.scripts.train``, ``test``, ``inference``,
  ``check_efficiency``, ``validate_submission``) with the JAX scripts' flags
  (``cli``) and log tree (``utils``); data and checkpoints are ``.npz`` /
  ``.pt`` files read with numpy and torch (``data.datasets``,
  ``train.trainer``), the efficiency gate is ``tools.efficiency``.

Public functions keep the JAX layouts: NHWC activations and ``[B, L, C]``
sequences. The package imports ``torch`` and never ``jax``, ``optax`` or
``h5py``, and nothing of ``lfsr_tpu``: what it needs of the JAX package's
plain-Python modules (``config``, ``cli``, ``utils``, ``tools``) it keeps
as its own copies.
"""

"""Logging, metric sheets, directory schema (the port's copy of ``lfsr_tpu.utils``)."""

from lfsr_tpu_torch.utils.logging import Logger, MetricSheet, create_dirs  # noqa: F401

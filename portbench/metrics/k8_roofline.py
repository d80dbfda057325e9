"""k8_roofline.<cell>: K8 (``ops/masked_attention.py``
``masked_mha_fused``; LFT's angular attention), percent of its roofline,
from the device time of the kernels launched inside the benchmark's
``portbench.K8`` spans (K8's count in ``counts/kernels.py``)."""

from portbench.harness.readers import roofline


def read(ctx):
    return roofline(ctx, "K8")

"""ang_torch_ms.<cell>: device milliseconds per unit in LFT's angular
blocks outside their kernels: the self time of the program's ``model.ang``
and ``model.ang.attn`` spans, less the kernel span (K8) nested in them: the
token transposes, the projections, the LayerNorms, the FFN and the
residuals."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "device_self_ms", lambda n: n.startswith("model.ang"))

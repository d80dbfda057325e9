"""spa_torch_ms.<cell>: device milliseconds per unit in LFT's spatial
blocks outside their kernels: the self time of the program's ``model.spa``
and ``model.spa.attn`` spans (event-timed on the stream), less the kernel
span (K12) nested in them: the embedding conv, the projections, the
LayerNorms, the FFN and the residuals."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "device_self_ms", lambda n: n.startswith("model.spa"))

"""blocks_torch_ms.<cell>: device milliseconds per unit in the flagship's
LFVSSM blocks outside their kernels: the self time of the program's
``model.block`` and ``model.block.ssm`` spans (event-timed on the stream),
less the kernel spans (K1, K4, K5, K7) nested in them."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "device_self_ms", lambda n: n.startswith("model.block"))

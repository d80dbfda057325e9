"""engine_ms.<cell>: device milliseconds per unit of the evaluation
engine's own work around the model's calls: the self time of the
program's ``eval.*`` spans but ``eval.forward`` (the upload, the pads, the
crops; on the tiled path the division and the integration)."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "device_self_ms", lambda n: n.startswith("eval.") and n != "eval.forward")

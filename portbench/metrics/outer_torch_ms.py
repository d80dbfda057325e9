"""outer_torch_ms.<cell>: device milliseconds per unit in the model's calls
outside its blocks and kernels: the self time of the program's
``eval.forward`` spans and of every ``model.*`` span but the blocks' (the
input, IFE, window attention's set-up around K6, the fusion, HLFR around
K10, the output)."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "device_self_ms",
                   lambda n: n == "eval.forward" or (n.startswith("model.")
                                                     and not n.startswith("model.block")))

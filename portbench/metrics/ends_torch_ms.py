"""ends_torch_ms.<cell>: device milliseconds per unit in LFT's calls
outside its blocks: the self time of the program's ``eval.forward``,
``model.input`` (the bicubic residual, the views), ``model.stem`` and
``model.output`` (the 1x1 expansion, the pixel shuffle, the last conv)
spans. LFT's blocks (``model.ang*``, ``model.spa*``) are read by
``ang_torch_ms`` and ``spa_torch_ms``."""

from portbench.metrics._program import span_ms

_SPANS = ("eval.forward", "model.input", "model.stem", "model.output")


def read(ctx):
    return span_ms(ctx, "device_self_ms", lambda n: n in _SPANS)

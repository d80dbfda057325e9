"""mfu.<cell>: the whole model's share of the card's peak, percent: the
model FLOPs of the untraced window's units (``counts/model_flops.py``:
``FlopCounterMode`` over the plain reference on the meta device at the
cell's shapes, forward and backward in training) over the window's time,
over the peak of the configuration's compute dtype (``counts/peaks.py``)."""

from portbench.counts.model_flops import window_flops
from portbench.counts.peaks import MODEL_PEAK


def read(ctx):
    win, loop = ctx["window"], ctx["loop"]
    peak = MODEL_PEAK[loop.cfg.compute_dtype]
    return 100.0 * window_flops(loop, win) / win["seconds"] / peak

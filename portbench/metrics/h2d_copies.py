"""h2d_copies.<cell>: host data copied to the device per unit, as the
program counts it at each upload site (``lfsr_tpu_torch.trace.upload``):
index tables, folded matrices, scalars, the scenes' mosaics."""

from portbench.metrics._program import counted


def read(ctx):
    return counted(ctx, "h2d_copies")

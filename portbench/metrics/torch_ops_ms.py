"""torch_ops_ms.<cell>: device milliseconds per unit (scene, step) of the
kernels launched outside every kernel span of the benchmark: PyTorch's own
elementwise, reduce, cuDNN and cuBLAS kernels (copies and sets left out)."""

from portbench.harness.readers import is_kernel, units


def read(ctx):
    t = ctx["trace"]
    ms = 1e3 * sum(sec for name, sec, span in t.kernels if span is None and is_kernel(name))
    return ms / units(ctx)

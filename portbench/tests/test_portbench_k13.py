"""K13's count (``counts/layer_norm.py``) and its roofline's reader
(``metrics/k13_roofline.py``) on the CPU.

    python -m pytest portbench/tests -q
"""

from types import SimpleNamespace

import pytest

from portbench.counts import layer_norm as counts
from portbench.harness import spec
from portbench.harness.trace import Operand

CELL = "lft.tiled_test"


def _op(shape, dtype):
    return Operand(tuple(shape), f"torch.{dtype}", 2 if dtype == "bfloat16" else 4)


def test_k13_count_by_hand():
    """x [3, 5, 16] bf16 with a float32 code [1, 5, 16] and float32 gamma,
    beta: 240 x 2 bytes read and written, 80 x 4 of code, 2 x 16 x 4 of
    gamma and beta; 8 operations an element with the code, 7 without."""
    x, code, g = _op((3, 5, 16), "bfloat16"), _op((1, 5, 16), "float32"), _op((16,), "float32")
    args = [x, g, g, code, "torch.bfloat16"]
    assert counts.work(args, [x]) == (240 * 2 * 2 + 80 * 4 + 2 * 16 * 4, 0.0, 240.0 * 8)
    assert counts.work([x, g, g, None, "torch.bfloat16"], [x]) == (
        240 * 2 * 2 + 2 * 16 * 4, 0.0, 240.0 * 7)
    # SpaTrans's call: 210 MB, 0.063 ms, set by the bytes
    x, code, g = (_op((400, 1024, 128), "bfloat16"), _op((1, 1024, 128), "bfloat16"),
                  _op((128,), "float32"))
    s, by = counts.bound_s([x, g, g, code, "torch.bfloat16"], [x])
    n = 400 * 1024 * 128
    assert by == "bytes" and s == pytest.approx((4 * n + 2 * 1024 * 128 + 8 * 128) / 3.35e12)


def test_the_roofline_reads_its_spans_alone():
    reader = spec.reader(spec.resolve(CELL), "k13_roofline.lft_tiled")
    x, g = _op((400, 1024, 128), "bfloat16"), _op((128,), "float32")
    call = ([x, g, g, None, "torch.bfloat16"], [x])
    least = counts.bound_s(*call)[0]
    kernels = [("layer_norm_kernel", least * 2, "K13"), ("layer_norm_kernel", least * 2, "K13"),
               ("Memcpy HtoD", 1.0, "K13"), ("other", 5.0, None)]
    trace = SimpleNamespace(calls={"K13": [call, call]}, kernels=kernels)
    assert reader.read({"trace": trace}) == pytest.approx(50.0)
    # a program without K13 launches none: nothing to read
    assert reader.read({"trace": SimpleNamespace(calls={}, kernels=kernels[3:])}) is None

"""K14's count (``counts/conv_silu.py``) and its roofline's reader
(``metrics/k14_roofline.py``) on the CPU.

    python -m pytest portbench/tests -q
"""

from types import SimpleNamespace

import pytest

from portbench.counts import conv_silu as counts
from portbench.harness import spec
from portbench.harness.trace import Operand

CELL = "lfmambax.whole_test"


def _op(shape, dtype):
    return Operand(tuple(shape), f"torch.{dtype}", 2 if dtype == "bfloat16" else 4)


def test_k14_count_by_hand():
    """xs [3, 5, 16] bf16 (the logged half of xz [3, 5, 32]: its own
    elements only), wconv [4, 16] and bconv [16] float32: 240 x 2 bytes read
    and written, 4 x 16 x 4 of taps, 16 x 4 of bias; 2 K + 4 = 12 operations
    an element."""
    xs, w, b = _op((3, 5, 16), "bfloat16"), _op((4, 16), "float32"), _op((16,), "float32")
    assert counts.work([xs, w, b], [xs]) == (240 * 2 * 2 + 64 * 4 + 16 * 4, 0.0, 240.0 * 12)
    assert counts.work([xs, _op((1, 16), "float32"), b], [xs])[2] == 240.0 * 6  # K 1
    # the Synth dispatch's call: 0.66 GB, 0.198 ms, set by the bytes
    xs, w, b = _op((4, 518400, 80), "bfloat16"), _op((4, 80), "float32"), _op((80,), "float32")
    s, by = counts.bound_s([xs, w, b], [xs])
    n = 4 * 518400 * 80
    assert by == "bytes" and s == pytest.approx((4 * n + 5 * 80 * 4) / 3.35e12)
    assert s == pytest.approx(0.198e-3, rel=1e-3)


def test_the_roofline_reads_its_spans_alone():
    reader = spec.reader(spec.resolve(CELL), "k14_roofline.whole")
    xs, w, b = _op((4, 563200, 80), "bfloat16"), _op((4, 80), "float32"), _op((80,), "float32")
    call = ([xs, w, b], [xs])
    least = counts.bound_s(*call)[0]
    kernels = [("conv_silu_kernel", least * 2, "K14"), ("conv_silu_kernel", least * 2, "K14"),
               ("Memcpy DtoD", 1.0, "K14"), ("chunk_scan_kernel", 5.0, "K1"), ("other", 5.0, None)]
    trace = SimpleNamespace(calls={"K14": [call, call]}, kernels=kernels)
    assert reader.read({"trace": trace}) == pytest.approx(50.0)
    # a program without K14 launches none: nothing to read
    assert reader.read({"trace": SimpleNamespace(calls={}, kernels=kernels[3:])}) is None

"""How the port's wrappers plan their kernel launches, without a card.

K1 and K2 run the chunk-parallel scan of csrc/scan_chunked.cu with the
chunk length of ``ops/scan.scan_chunk_len``; K3 the chunk-parallel reverse
scan of csrc/scan_adjoint.cu over chunks of the states' spacing; K8 runs its tensor-core kernel
for bfloat16 with a head dim of 16, 32 or 64 and its CUDA-core kernel
otherwise. The kernels themselves run only on the card
(tests/test_torch_port_cuda.py); here ``_cuda``'s device checks and its
``launch`` are replaced by recorders, so the wrappers' planning runs on CPU
tensors and the tests read what they would launch.
"""

import numpy as np
import pytest
import torch

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.ops import _cuda, masked_attention as ma, scan


@pytest.fixture
def launches(monkeypatch):
    """The wrappers take their kernel path on CPU tensors and every launch
    is recorded as (entry point, args) instead of run."""
    calls = []
    monkeypatch.setattr(_cuda, "use_plain", lambda t: False)
    monkeypatch.setattr(_cuda, "check", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("B,L", [(1, 1), (1, 63), (3, 65), (2, 25600), (8, 25600),
                                 (4, 518400), (4, 563200), (1, 10**7)])
def test_chunk_length_is_a_multiple_of_the_spacing_and_fills_the_card(B, L):
    tc = scan.scan_chunk_len(B, L)
    chunks = -(-L // tc)
    assert tc % scan.STATE_SPACING == 0 and tc >= scan.STATE_SPACING and chunks >= 1
    # the longest such chunk with B L / Tc >= SCAN_CTAS (batch row, chunk) pairs
    assert tc == scan.STATE_SPACING or B * L / tc >= scan.SCAN_CTAS
    assert B * L / (tc + scan.STATE_SPACING) < scan.SCAN_CTAS


def _scan_args(B, L, N=16, Di=80, R=4, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(Di, 1)
    return (torch.randn(B, L, Di, generator=g).to(dtype),
            torch.randn(B, L, R + 2 * N, generator=g).to(dtype), torch.randn(R, Di, generator=g),
            torch.randn(Di, generator=g), A, torch.ones(Di))


@pytest.mark.parametrize("B,L", [(1, 40), (2, 25600), (4, 518400 // 16)])
def test_k1_and_k2_launch_the_same_passes_and_chunks(launches, B, L):
    """Both wrappers take the three passes with the same Tc (K2's y is
    K1's bit for bit on the card); one chunk needs only the outputs pass.
    Arguments: summaries (..., N, Tc, dtype, stream), outputs (..., N, Tc,
    spacing, dtype, stream)."""
    args = _scan_args(B, L)
    tc = scan.scan_chunk_len(B, L)
    before = (trace.counter("launches/K1"), trace.counter("launches/K2"))
    with torch.no_grad():
        scan.selective_scan_proj(*args)
        k1 = list(launches)
        launches.clear()
        scan.selective_scan_proj_states(*args)
        k2 = list(launches)
    assert (trace.counter("launches/K1"), trace.counter("launches/K2")) == (
        before[0] + 1, before[1] + 1)
    names = ["lfsr_chunk_scan_outputs"]
    if L > tc:
        names = ["lfsr_chunk_scan_summaries", "lfsr_chunk_scan_carry", *names]
    assert [n for n, _ in k1] == [n for n, _ in k2] == names
    for (name, a1), (_, a2) in zip(k1, k2):
        if name == "lfsr_chunk_scan_outputs":
            assert a1[-5:-2] == a2[-5:-2] == (16, tc, scan.STATE_SPACING)
            assert a1[8] is None and a2[8] is not None  # K2 only writes states
        elif name == "lfsr_chunk_scan_summaries":
            assert a1[-4:-2] == a2[-4:-2] == (16, tc)
        else:  # the carry walks the summaries of all chunks but the last
            assert a1[-2] == a2[-2] == -(-L // tc) - 1


@pytest.mark.parametrize("B,L", [(1, 1), (3, 64), (2, 65), (3, 975), (8, 25600)])
def test_k3_plans_summaries_carry_adjoint_and_sum(launches, monkeypatch, B, L):
    """K3 over chunks of 64 steps (the spacing of K2's states): the
    summaries of chunks 1 .. nc-1 into [B, nc-1, N, Di] / [B, nc-1, Di],
    the carry over those nc - 1 summaries, the adjoint (seeded from that
    carry, each chunk's dA into [B, nc, N, Di]) and the sum of the nc
    chunks' dA; one chunk (L <= 64) is the adjoint alone, writing dA
    itself. One launch counted per call."""
    u, dbc, Wdt, bdt, A, _ = _scan_args(B, L)
    Di, N, R, tc = 80, 16, 4, scan.STATE_SPACING
    nc = -(-L // tc)
    dy, states = torch.randn(u.shape).to(u.dtype), torch.zeros(B, nc, N, Di)
    shapes, empty = [], torch.empty

    def recorded_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        shapes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", recorded_empty)
    before = trace.counter("launches/K3")
    du, ddt, dB, dC, dA = scan.selective_scan_proj_bwd(u, dbc, dy, Wdt, bdt, A, states)
    assert trace.counter("launches/K3") == before + 1
    outs = [(B, L, Di), (B, L, Di), (B, L, N), (B, L, N), (B, N, Di)]
    assert [tuple(t.shape) for t in (du, ddt, dB, dC, dA)] == outs
    calls = dict(launches)
    if nc == 1:
        assert [n for n, _ in launches] == ["lfsr_scan_adjoint"] and shapes == outs
        adj = calls["lfsr_scan_adjoint"]
        assert adj[7] is None and adj[12] == dA.data_ptr()
    else:
        assert [n for n, _ in launches] == ["lfsr_scan_adjoint_summaries", "lfsr_chunk_scan_carry",
                                            "lfsr_scan_adjoint", "lfsr_sum_parts"]
        assert shapes == outs + [(B, nc - 1, N, Di), (B, nc - 1, Di), (B, nc, N, Di)]
        summ, car = calls["lfsr_scan_adjoint_summaries"], calls["lfsr_chunk_scan_carry"]
        adj, total = calls["lfsr_scan_adjoint"], calls["lfsr_sum_parts"]
        assert summ[7:13] == (B, L, Di, R, N, tc)
        assert car[1:3] == summ[5:7] and car[3:7] == (B, Di, N, nc - 1)
        assert adj[7] == summ[5] and adj[12] not in (None, dA.data_ptr())
        assert total[:2] == (adj[12], dA.data_ptr()) and total[2:5] == (B, nc, N * Di)
    assert adj[8:12] == tuple(t.data_ptr() for t in (du, ddt, dB, dC))
    assert adj[13:19] == (B, L, Di, R, N, tc)


@pytest.mark.parametrize("dtype,hd,path", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 8, "fma"), (torch.float32, 8, "fma"), (torch.float32, 16, "fma"),
    (torch.float32, 32, "fma"), (torch.float32, 64, "fma")])
def test_k8_path_by_dtype_and_head_dim(launches, dtype, hd, path):
    """bfloat16 with hd 16/32/64: the tensor-core entry with the mask as
    given (row-major); float32 or hd 8: the CUDA-core entry with the mask
    transposed. ``launches/K8/<path>`` counts the one taken."""
    assert ma.kernel_path(dtype, hd) == path
    g = torch.Generator().manual_seed(1)
    L, D = 40, 128
    q, k, v = (torch.randn(2, L, D, generator=g).to(dtype) for _ in range(3))
    mask = torch.randn(L, L, generator=g)
    before = trace.counts("launches/K8/")
    ma.masked_mha_fused(q, k, v, mask, D // hd)
    ((name, args),) = launches
    assert trace.counts("launches/K8/")[path] == before[path] + 1
    assert sum(trace.counts("launches/K8/").values()) == sum(before.values()) + 1
    assert name == {"mma": "lfsr_masked_mha_mma", "fma": "lfsr_masked_mha"}[path]
    assert args[5:9] == (2, L, D, D // hd)
    assert args[9] == pytest.approx(hd**-0.5)
    if path == "mma":
        assert args[3] == mask.data_ptr()
    else:
        assert args[3] != mask.data_ptr() and args[10] == _cuda.DTYPE_CODES[dtype]


def test_k8_refuses_what_neither_kernel_takes(launches):
    q = torch.zeros(2, 40, 120, dtype=torch.bfloat16)  # hd 15
    with pytest.raises(ValueError, match="head dim"):
        ma.masked_mha_fused(q, q, q, torch.zeros(40, 40), 8)
    assert not launches
    np.testing.assert_equal(ma.MMA_HEAD_DIMS, (16, 32, 64))

"""The port's spans and counters (``lfsr_tpu_torch.trace``) on the CPU.

Off by default: nothing is recorded and no ``lfsr.*`` event reaches the
profiler. Under ``torch.profiler`` a whole-scene ``sr_views`` of the small
flagship records each stage of the model and of the evaluation engine and
each kernel wrapper the expected number of times, a masked train epoch each
stage of the step and the ``vjp.*`` spans of its backward, every recorded
name appears in the profiler's events, and ``h2d_copies`` equals the copies
worked out from the upload sites. Self times are checked on synthetic
records.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.data.datasets import TestScene, TrainArrays
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.train.evaluate import sr_views
from lfsr_tpu_torch.train.trainer import Trainer

from _torch_port import one_torch_thread  # noqa: F401

PHASES = ((2, 0.25), (1, None))  # 3 blocks, window attention after the first phase
BLOCKS, ATTN = 3, 1
CFG = Config(compute_dtype="float32",
             model_kwargs={"channels": 16, "d_state": 4, "phases": PHASES})
MB = CFG.whole_scene_minibatch


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def model():
    m = get_model(CFG, device="cpu")
    m.load_state_dict(init_params(CFG, torch.Generator().manual_seed(0)))
    return m


def _scenes(n: int, side: int = 50):
    """n scenes of one geometry: 5 x 5 views of side / 5 LR pixels, so each
    view takes a mirror pad of 2 (``_whole_pad_batch``)."""
    rng = np.random.default_rng(n)
    return [TestScene(f"s{i}", "Synthetic", rng.random((side, side), dtype=np.float32),
                      rng.random((4 * side, 4 * side), dtype=np.float32),
                      np.zeros((4 * side, 4 * side, 2), np.float32)) for i in range(n)]


def _lfsr_events(prof) -> set:
    return {e.name for e in prof.events() if e.name.startswith(trace.PREFIX)}


def _ancestors(r) -> list:
    out = []
    while r.parent is not None:
        r = r.parent
        out.append(r.name)
    return out


def _calls() -> dict:
    out: dict = {}
    for r in trace.records():
        out[r.name] = out.get(r.name, 0) + 1
    return out


def test_off_by_default_nothing_is_recorded(model):
    scenes = _scenes(MB)
    for _ in sr_views(model, scenes, CFG):
        pass
    assert trace.records() == [] and trace.summary() == {"spans": {}, "counts": {}}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert _lfsr_events(prof) == set() and trace.records() == []


def test_a_span_decides_at_entry():
    with trace.span("outer"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("inner"):
                trace.count("things", 2)
    assert [r.name for r in trace.records()] == ["inner"]
    assert _lfsr_events(prof) == {"lfsr.inner"}
    assert trace.summary()["counts"] == {"things": 2}


@pytest.mark.parametrize("dispatches", [1, 2])
def test_whole_scene_sr_views_records_every_stage(model, dispatches):
    scenes = _scenes(MB * dispatches)
    n = dispatches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(sr_views(model, scenes, CFG))
    assert len(got) == len(scenes)
    want = {
        # the model, per forward
        "model.input": n, "model.ife": n, "model.block": BLOCKS * n,
        "model.block.ssm": BLOCKS * n, "model.window_attention": ATTN * n, "model.fusion": n,
        "model.hlfr": n, "model.output": n,
        # the kernel wrappers: K1/K4/K5 and K14 (the Mamba's conv + SiLU) in
        # each block's SSM, K7 in each block (16 channels: ln_msl_takes
        # holds), K6 after each attention phase, K10 once, K11 at the 13
        # depthwise convs outside the blocks (11 of dw_apply's, LSFL's two
        # EPI convs)
        "K1": BLOCKS * n, "K4": BLOCKS * n, "K5": BLOCKS * n, "K7": BLOCKS * n,
        "K14": BLOCKS * n, "K6": ATTN * n, "K10": n, "K11": 13 * n,
        # the engine: one upload of the geometry group; the scene-count pad
        # and each call's view pad; each call's crop and the calls' join
        "eval.upload": 1, "eval.pad": 1 + n, "eval.forward": n, "eval.crop": n + 1,
    }
    assert _calls() == want
    assert _lfsr_events(prof) == {trace.PREFIX + k for k in want}
    # each dispatch: hi, wi, the window index table (one per attention
    # phase) and the folded out-conv matrix; the group: its one upload
    s = trace.summary()
    assert s["counts"] == {"h2d_copies": 1 + (2 + ATTN + 1) * n}
    assert {k: v["calls"] for k, v in s["spans"].items()} == want
    forward = s["spans"]["eval.forward"]
    inside = sum(v["host_ms"] for k, v in s["spans"].items()
                 if k.startswith("model.") and k != "model.block.ssm")
    assert forward["host_ms"] >= inside > 0
    assert forward["host_self_ms"] == pytest.approx(forward["host_ms"] - inside, abs=1e-6)


def test_masked_train_epoch_records_each_stage_and_the_backward():
    cfg = CFG.replace(batch_size=2)
    spe = 2
    rng = np.random.default_rng(3)
    data = TrainArrays(rng.random((4, 40, 40), dtype=np.float32),
                       rng.random((4, 160, 160), dtype=np.float32))
    tr = Trainer(cfg, spe, init_params(cfg, torch.Generator().manual_seed(0)), device="cpu")
    tr.run_epoch(data, 0)  # stages the data on the device
    assert cfg.use_masked_pretrain and cfg.augment
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = tr.run_epoch(data, 1)
    assert np.isfinite(m["loss"])
    calls = _calls()
    stages = ("train.gather", "train.draw", "train.step", "train.augment", "train.forward",
              "train.loss", "train.backward", "train.optimizer", "train.metrics")
    assert {k: calls[k] for k in stages} == dict.fromkeys(stages, spe)
    assert calls["train.readback"] == 1
    # the backward: K3's adjoint and the PlainVJP twins' of K4-K7 and K10
    assert calls["vjp.K3"] == calls["K3"] == BLOCKS * spe
    for k in ("K4", "K5", "K7"):
        assert calls[f"vjp.{k}"] == BLOCKS * spe, k
    assert calls["vjp.K6"] == ATTN * spe and calls["vjp.K10"] == spe
    # K2 inside each K1 wrapper (the training forward)
    assert calls["K2"] == calls["K1"] == BLOCKS * spe
    for r in trace.records():
        if r.name.startswith("vjp."):
            assert r.root.name == "train.step" and "train.backward" in _ancestors(r)
    assert _lfsr_events(prof) == {trace.PREFIX + k for k in calls}
    # the epoch's permutation; each step: dropout's scale in every block,
    # the window index tables, the folded out-conv matrix, and the view
    # mask's draw: its priorities and two Python scalars written into
    # device tensors
    per_step = BLOCKS + ATTN + 1 + 3
    assert trace.summary()["counts"] == {"h2d_copies": 1 + per_step * spe}


def _rec(name, t0, t1, parent=None, dev=None):
    r = trace._Record(name, 0, parent, None)
    r.t0, r.t1 = int(t0 * 1e6), int(t1 * 1e6)
    r.dev_ms = dev
    return r


def test_self_times_on_synthetic_records():
    """Host and device self times: each span less its direct children."""
    a = _rec("a", 0, 10, dev=8.0)
    b = _rec("b", 1, 4, a, dev=2.5)
    c = _rec("c", 2, 3, b, dev=1.0)
    d = _rec("b", 5, 9, a, dev=3.0)
    e = _rec("e", 20, 22)  # a CPU span: its device time is its host time
    got = trace.aggregate([a, b, c, d, e])
    assert got["a"]["calls"] == 1 and got["b"]["calls"] == 2
    assert got["a"]["host_ms"] == pytest.approx(10)
    assert got["a"]["host_self_ms"] == pytest.approx(10 - 3 - 4)
    assert got["a"]["device_self_ms"] == pytest.approx(8.0 - 2.5 - 3.0)
    assert got["b"]["host_ms"] == pytest.approx(7) and got["b"]["host_self_ms"] == pytest.approx(6)
    assert got["b"]["device_ms"] == pytest.approx(5.5)
    assert got["b"]["device_self_ms"] == pytest.approx(4.5)
    assert got["c"]["device_self_ms"] == pytest.approx(1.0)
    assert got["e"]["device_ms"] == got["e"]["host_ms"] == pytest.approx(2)


def test_the_counter_table_and_a_fresh_recording():
    trace.declare("probe/a", "probe/b")
    trace.reset_counts("probe/")
    trace.count("probe/a", 3)
    assert trace.counts("probe/") == {"a": 3, "b": 0} and trace.counter("probe/a") == 3
    assert trace.summary()["counts"] == {}  # counted while the profiler was off
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("first"):
            trace.count("probe/b")
    assert [r.name for r in trace.records()] == ["first"]
    with trace.span("between"):  # the profiler seen off
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("probe/a")
        with trace.span("second"):
            pass
    # the second recording dropped the first's records and tally
    assert [r.name for r in trace.records()] == ["second"]
    assert trace.summary()["counts"] == {"probe/a": 1}
    assert trace.counts("probe/") == {"a": 4, "b": 1}
    trace.reset_counts("probe/")
    assert trace.counts("probe/") == {"a": 0, "b": 0}


def test_decorated_function_spans_each_call():
    @trace.span("deco")
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f(1)
        f(2)
    assert _calls() == {"deco": 2} and _lfsr_events(prof) == {"lfsr.deco"}


def test_kernel_wrappers_carry_their_span_names():
    from lfsr_tpu_torch.ops import KERNELS

    table = trace.counts("launches/")
    for name, (fn, _, _) in KERNELS.items():
        assert fn.kernel == name.split()[0] and fn.kernel in table


def test_lft_forward_records_its_blocks_and_attentions():
    """LFT at its registered width on the CPU (the wrappers run their
    twins): each of the 4 blocks' angular and spatial stages once, each
    with one attention span, K8 inside the angular one and K12 inside the
    spatial one, and the stages' two LayerNorms each (K13, 16 in all)
    directly inside them (their launches, counted on the card, are the GPU
    tests')."""
    cfg = Config(model_name="LFT", compute_dtype="float32")
    m = get_model(cfg, device="cpu")
    m.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.rand(1, 40, 40, 1)
    with torch.inference_mode():
        m(x)  # the codes and K8's mask reach the device once, before the recording
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            y = m(x)
    assert y.shape == (1, 160, 160, 1)
    want = {"model.input": 1, "model.stem": 1, "model.ang": 4, "model.ang.attn": 4,
            "model.spa": 4, "model.spa.attn": 4, "model.output": 1, "K8": 4, "K12": 4,
            "K13": 16}
    assert _calls() == want
    assert _lfsr_events(prof) == {trace.PREFIX + k for k in want}
    k13_stages = []
    for r in trace.records():
        if r.name in ("K8", "K12"):
            stage = "model.ang" if r.name == "K8" else "model.spa"
            assert _ancestors(r) == [stage + ".attn", stage]
        if r.name == "K13":
            k13_stages += _ancestors(r)
    assert sorted(k13_stages) == ["model.ang"] * 8 + ["model.spa"] * 8
    assert trace.summary()["counts"] == {}  # no host data copied, nothing launched on the CPU

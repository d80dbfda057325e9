"""The general loops that drive the program: one per kind of traffic.

A traffic file names its loop (``"loop"``) and gives its parameters:

- ``scenes``: a closed loop of test-set passes through the program's
  evaluation entry ``train.evaluate.sr_views``, each scene's SR views
  copied to host memory; the pass's scenes in an order drawn from the seed.
  Unit: one scene.
- ``train``: ``Trainer.run_epoch`` epoch after epoch over a training set
  staged as the trainer stages it. Unit: one step of ``batch_size`` patches.
  Set-up runs epoch 0's first ``check_steps`` steps, which the check
  follows; the window starts at epoch 1.

Each loop's ``setup`` makes the weights and inputs from the seed and warms
up every shape the window uses; ``window`` runs the timed loop; ``traced``
a short sub-window under the profiler; ``release`` frees the program's
state; ``check`` compares what the window produced with the plain
reference (``checks.py``).
"""

from __future__ import annotations

import importlib
import time

import torch

from portbench.harness import checks, data
from portbench.harness.seeds import rng, stream_seed
from portbench.harness.trace import KernelSpans, activities, profiled, synchronize
from portbench.harness.weights import make_weights, param_count


def program_config(cell, seed: int, overrides: dict | None = None):
    """The program's ``Config`` for the cell: the configuration file's
    fields, then the traffic's, then ``overrides``; its ``seed`` (the
    trainer's random streams) drawn from ``seed``."""
    from lfsr_tpu_torch.config import Config

    fields = {**cell.config["config"], **cell.traffic.get("config", {}), **(overrides or {})}
    fields["seed"] = stream_seed(seed, "draws")
    return Config(**fields)


def reference_module(cell):
    return importlib.import_module(f"portbench.reference.{cell.config['reference']}")


class Loop:
    unit = "unit"

    def __init__(self, cell, seed: int, device="cuda", overrides: dict | None = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg = program_config(cell, seed, overrides)
        self.ref = reference_module(cell)
        self.kw = dict(self.cfg.model_kwargs)
        specs = self.ref.param_specs(self.kw, self.cfg.angRes, self.cfg.scale_factor)
        self.weights = make_weights(specs, seed, self.device)
        want = cell.config.get("params")
        if want is not None and overrides is None and param_count(self.weights) != want:
            raise AssertionError(f"{cell.config_name}: {param_count(self.weights)} parameters, "
                                 f"the configuration states {want}")

    def model(self):
        from lfsr_tpu_torch.models.registry import get_model

        m = get_model(self.cfg, device=self.device)
        m.load_state_dict(self.weights, strict=True)
        return m

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def traced(self):
        """The traced sub-window: (units, trace events, kernel calls)."""
        with KernelSpans() as spans:
            units, events = profiled(self.trace_units)
        return units, events, spans.calls


# ---------------------------------------------------------------------------
# scenes: a test-set pass through the evaluation engine
# ---------------------------------------------------------------------------

class Scenes(Loop):
    unit = "scene"

    def setup(self):
        from lfsr_tpu_torch.models.registry import whole_scene_default

        t = self.cell.traffic
        self.whole = whole_scene_default(self.cfg)
        if self.whole != (t["path"] == "whole"):
            raise AssertionError(f"{self.cell.name}: the config takes the "
                                 f"{'whole' if self.whole else 'tiled'} path, traffic says {t['path']}")
        self.scenes = data.test_scenes(rng(self.seed, "scenes"), t["geometries"], self.device)
        self.order = rng(self.seed, "order")
        # the check's preference among each geometry's scenes, drawn from the
        # seed: the first ``check_scenes`` that the window completed are compared
        pick = rng(self.seed, "check_sample")
        self.prefer = {g["subset"]: list(pick.permutation(
            [s.name for s in self.scenes if s.subset == g["subset"]])) for g in t["geometries"]}
        self.kept: dict = {}
        self.bad = 0
        self.net = self.model()
        # warm-up: one dispatch of each geometry (whole), or one scene (tiled)
        mb = self.cfg.whole_scene_minibatch if self.whole else 1
        for g in t["geometries"]:
            group = [s for s in self.scenes if s.subset == g["subset"]][:mb]
            self._run(group, keep=False)
        self.sync()

    def _chunks(self):
        """One pass: the scenes in a seeded order, cut where the program's
        calls fall (whole: one call per geometry, as ``scripts.test`` makes
        them; tiled: one scene a call)."""
        order = [self.scenes[i] for i in self.order.permutation(len(self.scenes))]
        if not self.whole:
            return [[s] for s in order]
        groups: dict = {}
        for s in order:
            groups.setdefault(s.subset, []).append(s)
        return list(groups.values())

    def _run(self, scenes, keep: bool = True) -> dict:
        """The scenes through ``sr_views``, each one's views copied to host
        memory; with ``keep`` (the timed window only) kept for the check."""
        from lfsr_tpu_torch.train.evaluate import sr_views

        done = {}
        for sc, views in sr_views(self.net, scenes, self.cfg):
            self.bad += (~torch.isfinite(views)).any() if self.device.type == "cuda" else 0
            host = views.cpu().numpy()
            if keep:
                self.kept[sc.name] = host
            done[sc.subset] = done.get(sc.subset, 0) + 1
        return done

    def window(self, seconds: float) -> dict:
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)
        counts: dict = {}
        t0 = time.perf_counter()
        while True:
            for chunk in self._chunks():
                for k, v in self._run(chunk).items():
                    counts[k] = counts.get(k, 0) + v
                if time.perf_counter() - t0 >= seconds:
                    elapsed = time.perf_counter() - t0
                    n = sum(counts.values())
                    return {"units": n, "seconds": elapsed, "by_subset": counts,
                            "attempted": n, "failed": int(self.bad)}

    def trace_units(self) -> dict:
        counts: dict = {}
        chunks = self._chunks()[: self.cell.traffic["trace_chunks"]]
        for chunk in chunks:
            for k, v in self._run(chunk, keep=False).items():
                counts[k] = counts.get(k, 0) + v
        return counts

    def release(self):
        del self.net
        want = self.cell.traffic["check_scenes"]
        self.sample = [n for sub, names in self.prefer.items()
                       for n in [m for m in names if m in self.kept][: want[sub]]]
        self.kept = {n: self.kept[n] for n in self.sample}
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def _ref_views(self, scene, q, keep: str | None = None):
        """The reference's views of ``scene`` at precision ``q``; kept under
        ``keep`` (the float32 reference and the one at the configuration's
        dtype are computed once a scene: the control reuses them)."""
        cache = self.__dict__.setdefault("_refs", {})
        if keep is not None:
            if (keep, scene.name) not in cache:
                cache[keep, scene.name] = self._ref_views(scene, q)
            return cache[keep, scene.name]
        cfg, ang, s = self.cfg, self.cfg.angRes, self.cfg.scale_factor
        lr = torch.as_tensor(scene.lr_y, device=self.device)
        if self.whole:
            return checks.whole_views(self.ref, self.weights, lr, self.kw, ang, s,
                                      cfg.whole_scene_pad, q)
        return checks.tiled_views(self.ref, self.weights, lr, self.kw, ang, s,
                                  cfg.patch_size_for_test, cfg.stride_for_test, q)

    def check(self, q=None) -> dict:
        """{"sr_gap": the largest over the sampled scenes (``checks.sr_gap``)}.
        With ``q`` (a lower precision) the reference at ``q`` stands in the
        program's place: the control."""
        from portbench.reference.common import F32

        own = checks.own_precision(self.cfg)
        gaps = []
        with checks.exact_float32():
            for sc in self.scenes:
                if sc.name not in self.sample:
                    continue
                want = self._ref_views(sc, F32, "float32")
                base = want if own.name == "float32" else self._ref_views(sc, own, "own")
                got = (self._ref_views(sc, q) if q is not None
                       else torch.as_tensor(self.kept[sc.name], device=self.device))
                gaps.append(checks.sr_gap(got, want, base))
        return {"sr_gap": max(gaps)}


# ---------------------------------------------------------------------------
# train: the trainer's epochs
# ---------------------------------------------------------------------------

class Train(Loop):
    unit = "step"

    def setup(self, fault: str | None = None):
        from lfsr_tpu_torch.data.datasets import TrainArrays
        from lfsr_tpu_torch.train.trainer import Trainer

        t, cfg = self.cell.traffic, self.cfg
        hr = (t["hr_view"], t["hr_view"])
        draw = rng(self.seed, "train_pairs")
        lr, hr_ = data.light_fields(draw, t["pairs"], hr, self.device)
        self.data = TrainArrays(*data.vary_contrast(draw, lr, hr_, *t["contrast"]))
        self.spe = t["pairs"] // cfg.batch_size
        self.trainer = Trainer(cfg, self.spe, self.weights, device=self.device)
        self.follow = checks.Follow(self.trainer, self.weights, t["check_steps"], fault)
        # epoch 0 cut to the followed steps: the same rows and draws as the
        # whole epoch's first steps (each epoch's streams are drawn step by
        # step; the schedule counts optimizer steps), and every shape of the
        # window warmed up; the window then runs whole epochs from epoch 1
        self.trainer.steps_per_epoch = t["check_steps"]
        try:
            with self.follow:
                self.trainer.run_epoch(self.data, 0)
        finally:
            self.trainer.steps_per_epoch = self.spe
        self.epoch = 1
        self.sync()

    def window(self, seconds: float) -> dict:
        st = self.trainer.opt_state
        bad0 = int(st.total_notfinite)
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.trainer.run_epoch(self.data, self.epoch)  # reads its metrics back: synchronised
            self.epoch += 1
            steps += self.spe
        elapsed = time.perf_counter() - t0
        return {"units": steps, "seconds": elapsed, "attempted": steps,
                "failed": int(st.total_notfinite) - bad0,
                "patches": steps * self.cfg.batch_size}

    def traced(self):
        """Steps ``trace_steps`` = (first, n) of one more epoch under the
        profiler, entered and left from inside the trainer's step; the rest
        of the epoch runs untraced."""
        from torch.profiler import record_function

        first, n = self.cell.traffic["trace_steps"]
        tr = self.trainer
        step = tr.train_step
        state = {"i": 0, "prof": None, "span": None}
        spans = KernelSpans()

        def stepped(*a, **k):
            from torch.profiler import profile

            i = state["i"]
            if i == first:
                synchronize()
                spans.__enter__()
                state["prof"] = profile(activities=activities())
                state["prof"].__enter__()
                state["span"] = record_function("portbench.window")
                state["span"].__enter__()
            out = step(*a, **k)
            if i == first + n - 1:
                synchronize()
                state["span"].__exit__(None, None, None)
                state["prof"].__exit__(None, None, None)
                spans.__exit__(None, None, None)
            state["i"] += 1
            return out

        tr.train_step = stepped
        try:
            tr.run_epoch(self.data, self.epoch)
        finally:
            del tr.train_step
            spans.__exit__(None, None, None)
        self.epoch += 1
        return {"step": n}, state["prof"].profiler.kineto_results.events(), spans.calls

    def release(self):
        del self.trainer
        self.follow.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, q=None) -> dict:
        """The program's first steps (read in set-up) against the
        reference's on the same rows and draws; with ``q``, the reference
        at that precision in the program's place (the control)."""
        from portbench.reference.common import F32

        with checks.exact_float32():
            if not hasattr(self, "want"):  # the float32 reference, once (the control reuses it)
                self.want = checks.reference_steps(self, F32)
            got = checks.reference_steps(self, q) if q is not None else self.follow.readings()
        return checks.train_gaps(got, self.want)


LOOPS = {"scenes": Scenes, "train": Train}


def make(cell, seed: int, device="cuda", overrides: dict | None = None) -> Loop:
    return LOOPS[cell.traffic["loop"]](cell, seed, device, overrides)

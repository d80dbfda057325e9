#!/usr/bin/env python3
"""Compare two trees of the port on one card, in turns, in one process pair.

    python3 scripts/ab_chip.py PARENT_TREE CHANGE_TREE kernels K4 K10
    python3 scripts/ab_chip.py PARENT_TREE CHANGE_TREE e2e --pairs 10

Each tree (a checkout of the repository, e.g. a ``git archive`` of the
parent commit unpacked into a git-ignored directory) gets one worker
process, started in that tree, that imports the tree's own ``chip_smoke``
and ``lfsr_tpu_torch`` (and builds that tree's kernels). The workers take
turns on the card, so both are timed on the same card within one call:

- ``kernels NAME ...``: each kernel at each of its main-path shapes in
  ``chip_smoke.kernel_cases`` (the same seeded inputs in both trees), in
  float32 and bfloat16, timed parent / change / change / parent with CUDA
  events (``chip_smoke.time_ms``), and the two trees' outputs compared bit
  for bit (a SHA-256 of the output's bytes).
- ``e2e``: the flagship's end-to-end paths of ``chip_smoke`` from the
  seeded init, set up and warmed up once in each worker: whole-scene
  Synth and Real (``whole_dispatches``: ms/scene of one 4-scene dispatch
  each), tiled eval of one scene (ms/scene) and the batch-8 'pallas'
  train step (``run_epoch`` of 4 steps, ms/step); ``--pairs`` pairs, the
  side that runs first alternating; medians, the parent's interquartile
  range and the pairs the change wins. Then one torch.profiler trace of
  each path in each tree (``chip_smoke.profile_run``: device busy and
  idle share).

Needs torch with CUDA and nvcc; imports nothing of JAX. The workers' logs
go to standard error; the summary to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RESULT = "@ab "


# --------------------------------------------------------------------------
# worker: runs in one tree, answers one JSON command a line
# --------------------------------------------------------------------------

def worker() -> None:
    sys.path.insert(0, os.getcwd())
    import hashlib

    import numpy as np
    import torch

    import chip_smoke as c

    c.log = lambda m: print(m, file=sys.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lfsr_tpu_torch.ops import KERNELS, _cuda

    c.CARD = c.card_info()
    _cuda.lib()
    kernels = {k.split()[0]: fn for k, (fn, _, _) in KERNELS.items()}
    state: dict = {}

    def kernel(name, where, dtype, iters):
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
        g = torch.Generator(device=c.DEVICE).manual_seed(c.SEED)
        args = next(a for n, w, a in c.kernel_cases(dt, g, (name,)) if w == where)
        fn = kernels[name]
        out = fn(*args)
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        digest = hashlib.sha256(b"".join(o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                         for o in outs)).hexdigest()
        ms = c.time_ms(lambda: fn(*args), iters, 3)
        del args, out, outs
        torch.cuda.empty_cache()
        return {"ms": ms, "digest": digest}

    def setup_e2e():
        from lfsr_tpu_torch.config import Config
        from lfsr_tpu_torch.train.evaluate import evaluate_sets
        from lfsr_tpu_torch.train.trainer import Trainer

        model, sd = c.seeded_model(Config(), 693_998)
        synth, real = (sc[: c.EVAL_SCENES] for sc in c.flagship_scenes())
        tiled_cfg = Config(whole_scene_for_test=False)
        scene = c.make_scene(np.random.default_rng(c.SEED), "tiled0", c.TILED_HR)
        evaluate_sets(model, {"Synthetic": [scene]}, tiled_cfg, log=lambda m: None)
        data = c.train_data(c.TRAIN_PATCHES)
        trainer = Trainer(Config(batch_size=8), c.TRAIN_STEPS, sd, device=c.DEVICE)
        for _ in range(c.TRAIN_WARMUP):
            trainer.run_epoch(data, 0)
        torch.cuda.synchronize()
        state.update(model=model, synth=synth, real=real, tiled_cfg=tiled_cfg, scene=scene,
                     data=data, trainer=trainer)

    def e2e():
        from lfsr_tpu_torch.config import Config
        from lfsr_tpu_torch.train.evaluate import evaluate_sets

        if not state:
            setup_e2e()
        s = state
        res = {}
        _, out = c.whole_dispatches(s["model"], Config(), s["synth"], s["real"], "whole")
        res["whole Synth ms/scene"] = out["Synth"][1]
        res["whole Real ms/scene"] = out["Real"][1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_sets(s["model"], {"Synthetic": [s["scene"]]}, s["tiled_cfg"], log=lambda m: None)
        torch.cuda.synchronize()
        res["tiled ms/scene"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        s["trainer"].run_epoch(s["data"], 0)
        torch.cuda.synchronize()
        res["train ms/step"] = 1e3 * (time.perf_counter() - t0) / c.TRAIN_STEPS
        return res

    def profile():
        from lfsr_tpu_torch.config import Config
        from lfsr_tpu_torch.train.evaluate import _whole_pad_batch

        if not state:
            setup_e2e()
        s, cfg = state, Config()
        x = _whole_pad_batch(torch.as_tensor(np.stack([sc.lr_y for sc in s["synth"]]),
                                             device=c.DEVICE), cfg.angRes,
                             cfg.whole_scene_pad)[0][..., None]
        c.profile_dispatch(s["model"], x, "whole-scene Synth", reps=1)
        c.profile_tiled_dispatch(s["model"], cfg)
        c.profile_run(lambda: s["trainer"].run_epoch(s["data"], 0), "train epoch of 4 steps",
                      reps=1)
        return {}

    print(RESULT + json.dumps({"ready": c.CARD}), flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "kernel":
            res = kernel(cmd["name"], cmd["where"], cmd["dtype"], cmd.get("iters", 20))
        elif cmd["cmd"] == "e2e":
            res = e2e()
        elif cmd["cmd"] == "profile":
            res = profile()
        else:
            break
        print(RESULT + json.dumps(res), flush=True)


# --------------------------------------------------------------------------
# controller: one worker per tree, asked in turns
# --------------------------------------------------------------------------

class Worker:
    def __init__(self, tree: str, tag: str):
        self.tag = tag
        self.proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--worker"], cwd=tree,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(RESULT):
                return json.loads(line[len(RESULT):])
            print(f"[{self.tag}] {line.rstrip()}", file=sys.stderr, flush=True)
        raise RuntimeError(f"worker {self.tag} ended (rc {self.proc.wait()})")

    def ask(self, **cmd) -> dict:
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            self.proc.wait(timeout=120)


def quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return q[0], q[2]


def run_kernels(a: Worker, b: Worker, names, where) -> None:
    for name in names:
        for dtype in ("bf16", "f32"):
            for w in where:
                cmd = dict(cmd="kernel", name=name, where=w, dtype=dtype)
                ra1, rb1, rb2, ra2 = a.ask(**cmd), b.ask(**cmd), b.ask(**cmd), a.ask(**cmd)
                same = ra1["digest"] == rb1["digest"]
                print(f"{name} {dtype:4s} {w:6s} parent / change / change / parent: "
                      f"{ra1['ms']:.4f} / {rb1['ms']:.4f} / {rb2['ms']:.4f} / {ra2['ms']:.4f} ms; "
                      f"outputs bit-equal: {same}", flush=True)


def run_e2e(a: Worker, b: Worker, pairs: int) -> None:
    runs = {"parent": [], "change": []}
    for i in range(pairs):
        order = ((a, "parent"), (b, "change")) if i % 2 == 0 else ((b, "change"), (a, "parent"))
        for w, side in order:
            runs[side].append(w.ask(cmd="e2e"))
        print(f"pair {i}: parent {runs['parent'][-1]} | change {runs['change'][-1]}", flush=True)
    for metric in runs["parent"][0]:
        pa = [r[metric] for r in runs["parent"]]
        ch = [r[metric] for r in runs["change"]]
        q1, q3 = quartiles(pa)
        wins = sum(x < y for x, y in zip(ch, pa))
        print(f"{metric}: median parent {statistics.median(pa):.2f} (IQR {q3 - q1:.2f}; "
              f"{min(pa):.2f}-{max(pa):.2f}), change {statistics.median(ch):.2f} "
              f"({min(ch):.2f}-{max(ch):.2f}); the change faster in {wins} of {pairs} pairs",
              flush=True)
    for w in (a, b):
        print(f"[{w.tag}] profile:", file=sys.stderr, flush=True)
        w.ask(cmd="profile")


def main() -> int:
    if "--worker" in sys.argv:
        worker()
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("what", choices=("kernels", "e2e"))
    ap.add_argument("names", nargs="*", help="kernels: the kernels, e.g. K4 K10")
    ap.add_argument("--where", nargs="+", default=["train", "tiled", "synth", "real"])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    a, b = Worker(args.parent, "parent"), Worker(args.change, "change")
    try:
        card = a.read()["ready"]
        b.read()
        print(f"card: {card}", flush=True)
        if args.what == "kernels":
            run_kernels(a, b, args.names, args.where)
        else:
            run_e2e(a, b, args.pairs)
    finally:
        a.close()
        b.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Readings for a cell's correctness limits, on the card, many seeds in one
process:

    python3 portbench/calibrate.py --workload lfmambax.whole_test \\
        --seeds 11,12,13 --seconds 4 [--control] [--fault half_batch]

For each seed it sets the cell up as a run does, runs a short window at the
cell's own load (long enough to finish the scenes or steps that a
run compares), and prints one JSON line: the numbers a run compares
(``program``); with ``--control``, the same numbers with the reference
computed at the precision below the configuration's put in the program's
place (``control``: float8 e4m3 for a bfloat16 model); with ``--fault``
(training cells), the numbers of the program with that fault planted
(``fault``). The lower reading of a limit is the largest ``program`` value
over a dozen seeds or more, the upper the smallest ``control`` (or fault)
value; ``limits/<cell>.json`` holds the limit set between them. Runs are
not timed; the benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROL = {"bfloat16": "float8", "float16": "float8", "float32": "bfloat16"}


def readings(cell, seed: int, seconds: float, control: bool, fault: str | None,
             device="cuda", overrides: dict | None = None) -> dict:
    import torch

    from portbench.harness import checks, loops
    from portbench.reference.common import Prec

    out = {"seed": seed}
    t0 = time.perf_counter()
    runs = [("program", None)] + ([("fault", fault)] if fault else [])
    for key, planted in runs:
        loop = loops.make(cell, seed, device, overrides)
        loop.setup(**({"fault": planted} if planted else {}))
        loop.window(seconds)
        loop.release()
        out[key] = loop.check()
        if cell.traffic["loop"] == "train":
            out[f"{key}_worst"] = checks.worst_leaves(loop.follow.readings(), loop.want)
        if key == "program" and control:
            q = Prec(CONTROL[loop.cfg.compute_dtype])
            out["control"] = loop.check(q=q)
            if cell.traffic["loop"] == "train":
                out["control_worst"] = checks.worst_leaves(checks.reference_steps(loop, q), loop.want)
        del loop
        if device == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("half_batch",))
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import spec

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    torch.set_num_threads(1)
    cell = spec.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.seconds, args.control, args.fault)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload lfmambax.whole_test --seed 12345 \\
        --seconds 20 --trace 0

from the root of a checkout. The cell (a ``workloads`` entry of
``BENCHMARK.json``) names a configuration and a traffic mix; the harness
finds their files by name (``harness/spec.py``), makes the weights and
inputs from ``--seed``, sets the program up and warms up the cell's shapes
(``setup_s``, from the start of the process to the start of the window),
runs the timed window for ``--seconds``, and with ``--trace 1`` also a
short traced sub-window whose per-layer metrics it reads with
``metrics/<family>.py``. Then it frees the program's state, compares what
the window produced with the plain reference (``reference/``), prints each
compared number beside its limit, and as the last line of standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the end-to-end ones; ``--trace 1``: the per-layer ones),
``device`` and, traced, ``breakdown``; the compared numbers last, under
``check``.

It exits non-zero, printing no result, when there is no CUDA device (or
fewer than the cell asks for), when the program cannot be imported, and
when JAX, its libraries or the JAX package were loaded in the process by
the time the check has run.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "lfsr_tpu")
CACHE = ROOT / ".portbench_cache"


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def end_to_end(cell, win: dict, setup_s: float) -> dict:
    out = {}
    stats = cell.traffic["statistics"]
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            value = setup_s
        else:
            kind = stats[name]
            if kind == "units_per_s":
                value = win["units"] / win["seconds"]
            elif kind == "patches_per_s":
                value = win["patches"] / win["seconds"]
            else:
                raise KeyError(f"{cell.traffic_name}: unknown statistic {kind!r}")
        out[name] = {"value": value, "unit": m["unit"]}
    return out


def per_layer(cell, loop, win: dict, trace, units: dict) -> dict:
    from portbench.harness.spec import reader

    ctx = {"cell": cell, "loop": loop, "window": win, "trace": trace, "trace_units": units}
    out = {}
    for m in cell.per_layer:
        value = reader(cell, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, device: str = "cuda", overrides: dict | None = None, root=ROOT) -> dict:
    """One run; returns the result. ``device="cpu"`` (tests only) skips the
    look for a card and runs the program's CPU path; ``overrides`` (tests
    only) is {"config": Config fields over the configuration's, "traffic":
    fields over the traffic file's}, to rehearse a run at a small size;
    ``root`` (tests only) is the checkout whose BENCHMARK.json and
    ``portbench/`` data name the cell."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches of PyTorch's extension builder and Triton at fixed paths in
    # the checkout, for a program that comes to use them (its own library
    # builds into lfsr_tpu_torch/_build/, in the checkout too)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import loops, spec

    cell = spec.resolve(args.workload, root=root)
    if device == "cuda":
        if not torch.cuda.is_available():
            fail("no CUDA device (torch.cuda.is_available() is False)")
        if torch.cuda.device_count() < cell.chips:
            fail(f"{cell.name} needs {cell.chips} devices, found {torch.cuda.device_count()}")
    try:
        import lfsr_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program (lfsr_tpu_torch) cannot be imported: {e}")
    torch.set_num_threads(1)  # one host thread: the program's host work is one Python thread

    overrides = overrides or {}
    cell.traffic.update(overrides.get("traffic", {}))
    loop = loops.make(cell, args.seed, device, overrides.get("config"))
    loop.setup()
    gc.collect()
    gc.freeze()  # set-up's objects leave the collector's scans in the window
    setup_s = time.perf_counter() - START
    win = loop.window(args.seconds)
    trace, units = None, None
    if args.trace:
        from portbench.harness.trace import reduce

        units, events, calls = loop.traced()
        trace = reduce(events, calls)
        del events
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        metrics = per_layer(cell, loop, win, trace, units)
    else:
        metrics = end_to_end(cell, win, setup_s)

    loop.release()
    t0 = time.perf_counter()
    numbers = loop.check()
    check_s = time.perf_counter() - t0
    found = forbidden_modules()  # the window, the trace and the check all ran in this process
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
    limits = cell.limits
    check = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in check.values())
    correct = correct and win["failed"] == 0
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    result["check"] = check
    print(f"portbench: {cell.name} seed {args.seed}: {win['units']} {loop.unit}s in "
          f"{win['seconds']:.3f} s, setup {setup_s:.3f} s, reference check {check_s:.3f} s"
          + (f", trace reduced in {trace.reduce_s:.3f} s (device events, matched to a launch, "
             f"in a kernel span: {trace.linked})" if trace else ""), file=sys.stderr)
    for k, c in check.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

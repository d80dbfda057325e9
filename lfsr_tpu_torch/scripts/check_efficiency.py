"""Track-2 efficiency gate (the port of the JAX package's ``check_efficiency.py``).

Parameters (< 1 M) and official MACs (< 20 G) at the official SAI input
[1, 1, 160, 160] with per-module breakdowns, the output shape, optionally
the latency and memory on the card (``--bench``), and the verdict; exit
code 0 on PASS, 1 on FAIL. ``--deploy`` sets ``model_kwargs['deploy']``
as the JAX script does.

    python -m lfsr_tpu_torch.scripts.check_efficiency [--bench] [--detailed] [--json]
"""

from __future__ import annotations

import json

from lfsr_tpu_torch.cli import build_parser, config_from_args
from lfsr_tpu_torch.tools.efficiency import check_efficiency, format_report


def main(argv=None, device="cuda") -> int:
    p = build_parser()
    p.add_argument("--bench", action="store_true", help="run latency benchmark")
    p.add_argument("--deploy", action="store_true", help="test the reparameterized graph")
    p.add_argument("--detailed", action="store_true",
                   help="per-module params + FLOPs table "
                        "(check_efficiency_official.py:456-463)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    if args.deploy:
        cfg = cfg.replace(model_kwargs={**cfg.model_kwargs, "deploy": True})
    report = check_efficiency(cfg, bench=args.bench, device=device)
    if args.json:
        print(json.dumps(report, default=str))
    else:
        print(format_report(report, detailed=args.detailed))
    return 0 if report["verdict"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

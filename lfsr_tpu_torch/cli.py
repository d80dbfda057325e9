"""Command-line flags of the port's entry points.

The port's own copy of ``lfsr_tpu/cli.py``: every flag, default and help
text, so a command line written for the JAX package's ``train.py``,
``test.py``, ``inference.py`` or ``check_efficiency.py`` means the same
run under ``python -m lfsr_tpu_torch.scripts.*``; ``config_from_args``
builds the port's ``Config`` (tests/test_torch_port_cli.py holds the two
field by field).
"""

from __future__ import annotations

import argparse
import json

from lfsr_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", type=str, default="SR")
    p.add_argument("--angRes", type=int, default=5)
    p.add_argument("--angRes_out", type=int, default=None,
                   help="RE task: output angular resolution (e.g. 5 for 2x2->5x5)")
    p.add_argument("--scale_factor", type=int, default=4)
    p.add_argument("--model_name", type=str, default="LFMambaX")
    p.add_argument("--use_pre_ckpt", action="store_true")
    p.add_argument("--path_pre_pth", type=str, default="")
    p.add_argument("--data_name", type=str, default="ALL")
    p.add_argument("--path_for_train", type=str, default="./data_for_train/")
    p.add_argument("--path_for_test", type=str, default="./data_for_test/")
    p.add_argument("--path_log", type=str, default="./log/")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--decay_rate", type=float, default=1e-4)
    p.add_argument("--epoch", type=int, default=51)
    p.add_argument("--warmup_epochs", type=int, default=None,
                   help="default: min(5, epoch // 10), the reference recipe")
    p.add_argument("--eval_every", type=int, default=5,
                   help="validation cadence in epochs (train.py:177)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_masked_pretrain", type=int, default=1)
    p.add_argument("--mask_ratio", type=float, default=0.3)
    p.add_argument("--minibatch_for_test", type=int, default=2)
    p.add_argument("--whole_scene_minibatch", type=int, default=4)
    p.add_argument("--whole_scene_for_test", type=int, default=-1,
                   help="1: evaluate each scene as ONE un-tiled SAI call "
                        "(no 32/16 overlap grid; TPU fits whole scenes); "
                        "0: force tiled; -1 (default): auto per model "
                        "registry capability")
    p.add_argument("--epsw_for_test", type=int, default=0,
                   help="1: EPSW Gaussian-blended patch stitching "
                        "(MyEfficientLFNetV4_3.py:148) instead of the "
                        "hard center crop; tiled eval only")
    p.add_argument("--model_kwargs", type=str, default="{}",
                   help="JSON dict of per-model overrides")
    return p


def config_from_args(args) -> Config:
    return Config(
        task=args.task,
        angRes=args.angRes,
        angRes_out_re=args.angRes_out,
        scale_factor=args.scale_factor,
        model_name=args.model_name,
        model_kwargs=json.loads(args.model_kwargs),
        data_name=args.data_name,
        path_for_train=args.path_for_train,
        path_for_test=args.path_for_test,
        path_log=args.path_log,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.decay_rate,
        epochs=args.epoch,
        warmup_epochs=args.warmup_epochs,
        eval_every=args.eval_every,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
        use_masked_pretrain=bool(args.use_masked_pretrain),
        mask_end_ratio=args.mask_ratio,
        minibatch_for_test=args.minibatch_for_test,
        whole_scene_minibatch=args.whole_scene_minibatch,
        whole_scene_for_test=(
            None if args.whole_scene_for_test < 0
            else bool(args.whole_scene_for_test)
        ),
        epsw_for_test=bool(args.epsw_for_test),
    )

"""Port vs JAX: the command line of the entry points.

The port's own copy of ``lfsr_tpu/cli.py`` (``lfsr_tpu_torch.cli``) must
declare the same flags, with the same types, defaults and help texts, and
``config_from_args(build_parser().parse_args(argv))`` must give the JAX
package's ``Config``, field by field, for the defaults and for argv lists
that set every flag. Exact equality: no tolerance.
"""

import dataclasses

import pytest

from lfsr_tpu import cli as jcli
from lfsr_tpu_torch import cli

from _torch_port import one_torch_thread  # noqa: F401

ARGVS = [
    [],
    ["--task", "RE", "--angRes", "2", "--angRes_out", "5", "--scale_factor", "2",
     "--model_name", "EPIT", "--use_pre_ckpt", "--path_pre_pth", "ckpt.pth",
     "--data_name", "HCI_new", "--path_for_train", "tr/", "--path_for_test", "te/",
     "--path_log", "lg/", "--batch_size", "8", "--lr", "1e-3", "--decay_rate", "0.01",
     "--epoch", "7", "--warmup_epochs", "2", "--eval_every", "3", "--compute_dtype", "float32",
     "--seed", "11", "--use_masked_pretrain", "0", "--mask_ratio", "0.5",
     "--minibatch_for_test", "6", "--whole_scene_minibatch", "2", "--whole_scene_for_test", "0",
     "--epsw_for_test", "1", "--model_kwargs", '{"channels": 16, "phases": [[2, 0.25], [1, null]]}'],
    ["--whole_scene_for_test", "1", "--use_masked_pretrain", "1", "--epsw_for_test", "0"],
    ["--epoch", "1", "--batch_size", "8", "--warmup_epochs", "0", "--model_kwargs", "{}"],
]


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.help, a.nargs, a.const)
            for a in parser._actions]


def test_parser_declares_the_jax_flags():
    assert _actions(cli.build_parser()) == _actions(jcli.build_parser())


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "every-flag", "whole-on", "chip-smoke"])
def test_config_from_args_equals_the_jax_config(argv):
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.task_tag() == theirs.task_tag()

"""The port's own ``Config`` against the JAX package's: the same fields,
in the same order, with the same types and defaults, and the same
``mk``/``replace``/derived properties. The port keeps its own copy (it
imports nothing of ``lfsr_tpu``); this holds the two from drifting apart,
which also keeps the port tests that hand a JAX ``Config`` to port
functions valid."""

import dataclasses

import pytest

from lfsr_tpu.config import Config as JConfig
from lfsr_tpu_torch.config import Config

from _torch_port import one_torch_thread  # noqa: F401


def _default(f):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


def test_fields_types_and_defaults_are_the_jax_packages():
    ours, theirs = dataclasses.fields(Config), dataclasses.fields(JConfig)
    assert [f.name for f in ours] == [f.name for f in theirs]
    for a, b in zip(ours, theirs):
        assert a.type == b.type, a.name
        assert _default(a) == _default(b), a.name
    assert Config.__dataclass_params__.frozen and JConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [{}, {"model_name": "EPIT", "batch_size": 8},
                                {"task": "RE", "angRes_out_re": 7, "model_kwargs": {"n_blocks": 1}},
                                {"compute_dtype": "float32", "whole_scene_for_test": False}])
def test_methods_and_derived_fields_agree(kw):
    ours, theirs = Config(**kw), JConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for key, default in (("n_blocks", 5), ("channels", 64)):
        assert ours.mk(key, default) == theirs.mk(key, default)
    assert (ours.angRes_in, ours.angRes_out, ours.task_tag()) == (
        theirs.angRes_in, theirs.angRes_out, theirs.task_tag())
    r1, r2 = ours.replace(lr=1e-3, seed=3), theirs.replace(lr=1e-3, seed=3)
    assert type(r1) is Config and dataclasses.asdict(r1) == dataclasses.asdict(r2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.lr = 1.0

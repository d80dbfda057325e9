"""Port vs JAX: the efficiency gate.

- Parameters: the total and the per-module breakdown equal the JAX
  package's ``count_params`` on the flax init exactly.
- Official MACs: ``official_macs`` equals JAX's ``fvcore_macs_detailed``
  (which only traces; on the CPU JAX runs the window attention as its
  Pallas kernel in interpret mode, fault F4) module by module, exactly, at
  the dryrun flagship on [1, 40, 40, 1] and on a batch of 2 non-square
  mosaics, and at ``Config()`` on the official [1, 160, 160, 1] (693,998
  parameters, 18,118,185,344 MACs).
- The report: ``verdict``, ``output_shape_pass`` and ``format_report``'s
  lines (all but JAX's XLA line) equal JAX's ``check_efficiency`` at the
  dryrun config; a model over the parameter limit fails the gate, and
  ``scripts/inference.main`` then returns None and writes no submission.
- Without a card the gate raises unless it is asked for the CPU, and
  ``bench`` never falls back to the CPU.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from lfsr_tpu.config import Config as JConfig
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.tools import efficiency as jeff
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.tools import efficiency as eff

from _torch_port import one_torch_thread  # noqa: F401

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
CASES = [(dict(compute_dtype="float32", model_kwargs=SMALL), (1, 40, 40, 1)),
         (dict(compute_dtype="float32", model_kwargs=SMALL), (2, 48, 32, 1)),
         ({}, (1, 160, 160, 1))]
IDS = ["dryrun", "dryrun-batch2-nonsquare", "Config()"]


def _jax_counts(kw, shape):
    model = jget_model(JConfig(**kw))
    x = jnp.zeros(shape, jnp.float32)
    v = jax.eval_shape(model.init, jax.random.key(0), x)
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)
    params, breakdown = jeff.count_params({"params": v["params"]})
    macs, by_module = jeff.fvcore_macs_detailed(model.apply, v, x)
    return params, breakdown, macs, by_module


@pytest.mark.parametrize("kw,shape", CASES, ids=IDS)
def test_params_and_official_macs_equal_jax_module_by_module(kw, shape):
    params, breakdown, macs, by_module = _jax_counts(kw, shape)
    r = eff.check_efficiency(Config(**kw), input_shape=shape, device="cpu")
    assert r["params"] == params
    assert r["param_breakdown"] == breakdown
    assert r["official_fvcore_macs"] == macs
    assert r["flops_breakdown"] == by_module
    assert sum(r["flops_breakdown"].values()) == macs
    if not kw:
        assert (params, macs) == (693_998, 18_118_185_344)
        assert r["verdict"] and r["output_shape_pass"] and r["official_pass"]


def test_report_and_lines_equal_jax_check_efficiency():
    kw = dict(compute_dtype="float32", model_kwargs=SMALL)
    want = jeff.check_efficiency(JConfig(**kw), input_shape=(1, 40, 40, 1))
    got = eff.check_efficiency(Config(**kw), input_shape=(1, 40, 40, 1), device="cpu")
    assert set(got) == set(want)
    for k in ("model", "input_shape", "params", "non_trainable", "params_limit", "params_pass",
              "official_fvcore_macs", "official_pass", "flops_limit", "output_shape_pass",
              "verdict"):
        assert got[k] == want[k], k
    assert (got["xla_flops"], got["flops_mac_convention"], got["flops_pass"]) == (None,) * 3
    for detailed in (False, True):
        jl = [l for l in jeff.format_report(want, detailed).splitlines() if "xla raw" not in l]
        tl = eff.format_report(got, detailed).splitlines()
        assert sorted(tl) == sorted(jl)
        assert [l for l in tl if not l.startswith("  ")] == [l for l in jl if not l.startswith("  ")]


def test_gate_refusal_returns_none_and_writes_no_submission(tmp_path):
    from lfsr_tpu_torch.scripts import inference

    big = Config(model_kwargs={"channels": 96}, path_log=str(tmp_path / "log"),
                 path_for_test=str(tmp_path / "missing"))
    r = eff.check_efficiency(big, device="cpu")
    assert not r["params_pass"] and not r["verdict"]
    assert inference.main(big, out_root=str(tmp_path / "sub"), device="cpu") is None
    assert not (tmp_path / "sub").exists() and not (tmp_path / "sub.zip").exists()
    log = next((tmp_path / "log").rglob("LFMambaX_infer.txt")).read_text()
    assert "efficiency gate FAILED" in log and "VERDICT: FAIL" in log


def test_gate_refuses_a_missing_card_and_a_cpu_bench(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a machine with no card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eff.check_efficiency(Config())
    with pytest.raises(ValueError, match="bench times the card"):
        eff.check_efficiency(Config(), bench=True, device="cpu")
    with pytest.raises(NotImplementedError, match="LFMambaX only"):
        eff.official_macs(Config(model_name="EPIT"))

"""Port vs JAX: the small flagship's train step under ``scan_impl='gated'``
and ``'fused'``.

The dryrun flagship (channels 16, d_state 4, phases ((2, 0.25), (1, None))),
float32, batch 2 of 80x80 LR SAI patches (320x320 HR): the blocks' scans
run at L = 6400 = 25 x 256, above 4096, so the port's twins (K9b's and
K9c's on the CPU, and their gradients through ``_cuda.PlainVJP``) take the
chunked scan, as JAX's references do. JAX's CPU ``Mamba`` takes
``mamba_inner_ref`` under every impl; its step is built here as in
``test_torch_port_train_step.py`` (``registry.get_model``/``get_loss``,
``make_optimizer``, ``jax.value_and_grad`` with ``train=False``), the port's
``Trainer`` has its model in ``.eval()``, augmentation and masking are
off, and both start from one perturbed flax param tree. Since JAX's side
is the same function under both impls, one JAX run serves both.

Tolerances: the loss of both steps 1e-5 relative; every parameter 1e-6
absolute after the second step (float32 gradients summed in another order;
lr 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lfsr_tpu.config import Config
from lfsr_tpu.models.registry import get_loss as jget_loss
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.train.trainer import make_optimizer
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import state_dict_from_flax
from lfsr_tpu_torch.ops import scan
from lfsr_tpu_torch.train.trainer import Draws, Trainer

from _torch_port import one_torch_thread  # noqa: F401

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
SPE = 4


def _cfg(impl):
    return Config(compute_dtype="float32", batch_size=2, augment=False,
                  use_masked_pretrain=False, lr=1e-3, epochs=4, warmup_epochs=0,
                  model_kwargs={**SMALL, "scan_impl": impl})


def _batches():
    rng = np.random.default_rng(0)
    hr = rng.random((4, 320, 320)).astype(np.float32)
    lr = hr.reshape(4, 80, 4, 80, 4).mean(axis=(2, 4)).astype(np.float32)
    return [(lr[i : i + 2], hr[i : i + 2]) for i in range(0, 4, 2)]


def _perturbed_params(cfg, x):
    params = jax.jit(jget_model(cfg).init)(jax.random.key(0), jnp.asarray(x))
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)["params"]


def _jax_step(cfg):
    model, loss_fn, tx = jget_model(cfg), jget_loss(cfg), make_optimizer(cfg, SPE)

    @jax.jit
    def step(params, opt_state, x, y):
        def f(p):
            return loss_fn(model.apply({"params": p}, x, train=False), y)

        loss, grads = jax.value_and_grad(f)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return tx, step


@pytest.fixture(scope="module")
def chunked_calls():
    """Counts the twins' calls of the chunked scan (its checkpointed chunks
    then run again in backward)."""
    calls = []
    real = scan.selective_scan_chunked

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    scan.selective_scan_chunked = spy
    yield calls
    scan.selective_scan_chunked = real


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, once: JAX's CPU ``Mamba`` takes ``mamba_inner_ref``
    under 'gated' and 'fused' alike, so one run of two steps (under 'gated')
    is the reference of both. Returns the initial params and, per step,
    the loss and the params after it."""
    cfg = _cfg("gated")
    batches = _batches()
    params = _perturbed_params(cfg, batches[0][0][..., None])
    tx, jstep = _jax_step(cfg)
    jparams, jstate, steps = params, tx.init(params), []
    for lr, hr in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(lr[..., None]),
                                       jnp.asarray(hr[..., None]))
        steps.append((float(jloss), jparams))
    return params, steps


@pytest.mark.parametrize("impl", ["gated", "fused"])
def test_two_steps_match_jax(jax_run, chunked_calls, impl):
    cfg = _cfg(impl)
    params, steps = jax_run
    trainer = Trainer(cfg, SPE, state_dict_from_flax({"params": params}, cfg), device="cpu")
    trainer.model.eval()
    kern = {"gated": scan.scan_gated_fused, "fused": scan.mamba_inner_fused}[impl]
    before, calls = trace.counter(f"launches/{kern.kernel}"), len(chunked_calls)
    for i, ((lr, hr), (jloss, _)) in enumerate(zip(_batches(), steps)):
        m = trainer.train_step(torch.from_numpy(lr), torch.from_numpy(hr), Draws())
        np.testing.assert_allclose(m["loss"].item(), jloss, rtol=1e-5, err_msg=f"step {i}")
    assert trace.counter(f"launches/{kern.kernel}") == before  # CPU tensors: the twins, no launch
    # 3 blocks, forward and backward of each step, all at L = 6400
    assert len(chunked_calls) - calls >= 2 * 3 * 2
    assert all(shape[1] == 6400 for shape in chunked_calls[calls:])
    want = state_dict_from_flax({"params": steps[-1][1]}, cfg)
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
    assert int(trainer.opt_state.count) == 2

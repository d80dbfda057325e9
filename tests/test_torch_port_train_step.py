"""Port vs JAX: the whole train step of the small flagship.

The dryrun flagship (channels 16, d_state 4, phases ((2, 0.25), (1, None))),
float32, batch 2 of 40x40 LR SAI patches (160x160 HR). The JAX side is
built here from ``registry.get_model``/``get_loss``, ``make_optimizer`` and
``jax.value_and_grad`` with ``train=False``; the port's ``Trainer`` has its
model in ``.eval()``. Both start from one flax param tree (the JAX init,
perturbed), converted by the bridge. With dropout, augmentation and masking
off, three steps on three batches; then a fourth with masking on, the same
view mask and SRACM mask on both sides (read back from JAX's masked input).

Tolerances: the loss of every step 1e-5 relative; every parameter 1e-6
absolute after the third and the fourth step (the updates are ~1e-3: lr
1e-3 and Adam's normalised step), and those steps' updates (parameter
changes) 2e-3 relative to their largest element (float32 gradients summed
in another order; Adam divides by sqrt(v), so an element whose gradient is
near 0 moves by a noisy fraction of lr).
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
from lfsr_tpu.train import masking as jmask
from lfsr_tpu.train.trainer import make_optimizer
from lfsr_tpu_torch.bridge import state_dict_from_flax
from lfsr_tpu_torch.train.trainer import Draws, Trainer

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
CFG = Config(compute_dtype="float32", batch_size=2, augment=False, use_masked_pretrain=False,
             lr=1e-3, epochs=4, warmup_epochs=0, model_kwargs=SMALL)
SPE = 4
ANG = 5


def _perturbed_params(x):
    params = jax.jit(jget_model(CFG).init)(jax.random.key(0), jnp.asarray(x))
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)["params"]


def _jax_step():
    model, loss_fn, tx = jget_model(CFG), jget_loss(CFG), make_optimizer(CFG, SPE)

    @jax.jit
    def step(params, opt_state, x, y):
        def f(p):
            return loss_fn(model.apply({"params": p}, x, train=False), y)

        loss, grads = jax.value_and_grad(f)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return tx, step


def _batches():
    rng = np.random.default_rng(0)
    hr = rng.random((8, 160, 160)).astype(np.float32)
    lr = hr.reshape(8, 40, 4, 40, 4).mean(axis=(2, 4)).astype(np.float32)
    return [(lr[i : i + 2], hr[i : i + 2]) for i in range(0, 8, 2)]


def _masked_input(x):
    """JAX's view mask + SRACM of x [B, A*h, A*w, 1] with a key whose batch
    is masked; returns the masked input and the two masks read back from it
    (x is positive, so a zero marks a mask)."""
    h = x.shape[1] // ANG
    for seed in range(20):
        k1, k2 = jax.random.split(jax.random.key(seed))
        xm = jmask.mask_views(k1, jnp.asarray(x), ANG, 2)
        xm = np.asarray(jmask.sracm(k2, xm, ANG, 0.1))
        views = xm[0, ..., 0].reshape(ANG, h, ANG, h)
        keep = (np.abs(views).sum(axis=(1, 3)) > 0).astype(np.float32)
        if keep.sum() == ANG * ANG - 2:
            u, v = np.argwhere(keep > 0)[0]
            return xm, keep, views[u, :, v, :] != 0
    raise AssertionError("no masked batch in 20 keys")


def _assert_params(trainer, jparams, before=None, jbefore=None):
    want = state_dict_from_flax({"params": jparams}, CFG)
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
    if before is not None:
        dw = np.concatenate([(want[k] - jbefore[k]).numpy().ravel() for k in want])
        dg = np.concatenate([(got[k] - before[k]).numpy().ravel() for k in want])
        assert np.abs(dw).max() > 1e-4  # the step moved the parameters
        assert np.abs(dg - dw).max() <= 2e-3 * np.abs(dw).max()


@pytest.fixture(scope="module")
def run():
    """Both sides after three unmasked steps, with what each step gave."""
    batches = _batches()
    jparams = _perturbed_params(batches[0][0][..., None])
    tx, jstep = _jax_step()
    jstate = tx.init(jparams)
    trainer = Trainer(CFG, SPE, state_dict_from_flax({"params": jparams}, CFG), device="cpu")
    trainer.model.eval()
    steps = []
    for lr, hr in batches[:3]:
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        jbefore = state_dict_from_flax({"params": jparams}, CFG)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(lr[..., None]),
                                       jnp.asarray(hr[..., None]))
        m = trainer.train_step(torch.from_numpy(lr), torch.from_numpy(hr), Draws())
        steps.append((m, float(jloss), before, jbefore, jparams))
    return dict(batches=batches, jstep=jstep, jstate=jstate, trainer=trainer, steps=steps)


def test_three_steps_match_jax(run):
    trainer = run["trainer"]
    for i, (m, jloss, before, jbefore, jparams) in enumerate(run["steps"]):
        np.testing.assert_allclose(m["loss"].item(), jloss, rtol=1e-5, err_msg=f"step {i}")
        assert np.isfinite(m["psnr"].item()) and 0 < m["ssim"].item() < 1
        if i == 2:  # the port's parameters now are those after the third step
            _assert_params(trainer, jparams, before, jbefore)
    assert int(trainer.opt_state.count) == 3


def test_masked_fourth_step_matches_jax(run):
    trainer, (lr, hr) = run["trainer"], run["batches"][3]
    jparams = run["steps"][-1][4]
    xm, view_keep, sracm_keep = _masked_input(lr[..., None])
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    jbefore = state_dict_from_flax({"params": jparams}, CFG)
    jparams, _, jloss = run["jstep"](jparams, run["jstate"], jnp.asarray(xm),
                                     jnp.asarray(hr[..., None]))
    draws = Draws(view_keep=torch.from_numpy(view_keep), sracm_keep=torch.from_numpy(sracm_keep))
    m = trainer.train_step(torch.from_numpy(lr), torch.from_numpy(hr), draws)
    np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=1e-5)
    _assert_params(trainer, jparams, before, jbefore)

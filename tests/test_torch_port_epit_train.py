"""Port vs JAX: EPIT's train step.

EPIT at full width with one AltFilter (channels 64, so both EPI passes take
K8: the JAX side its Pallas kernel in interpret mode with the reference's
gradient, the port its wrapper, the twin on CPU tensors, through
``_cuda.PlainVJP``), float32, batch 2 of 40x40 LR SAI patches (160x160 HR),
augmentation and masking off. The JAX side is built from
``registry.get_model``/``get_loss`` (L1) and ``make_optimizer``; EPIT takes
no train flag on either side. Both start from the JAX init, converted by
the bridge; two steps on two batches.

Tolerances: each step's loss 1e-5 relative; every parameter 1e-6 absolute
after the second step (updates are ~1e-3: lr 1e-3 and Adam's normalised
step; float32 gradients summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lfsr_tpu.config import Config
from lfsr_tpu.models.registry import get_loss as jget_loss
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.train.trainer import make_optimizer
from lfsr_tpu_torch.bridge import state_dict_from_flax
from lfsr_tpu_torch.train.trainer import _TRAIN_FLAG_MODELS, Draws, Trainer

from _torch_port import one_torch_thread  # noqa: F401

CFG = Config(model_name="EPIT", compute_dtype="float32", batch_size=2, augment=False,
             use_masked_pretrain=False, lr=1e-3, epochs=4, warmup_epochs=0,
             model_kwargs={"n_blocks": 1})
SPE = 4


def _batches():
    rng = np.random.default_rng(0)
    hr = rng.random((4, 160, 160)).astype(np.float32)
    lr = hr.reshape(4, 40, 4, 40, 4).mean(axis=(2, 4)).astype(np.float32)
    return [(lr[i : i + 2], hr[i : i + 2]) for i in range(0, 4, 2)]


def _jax_step():
    model, loss_fn, tx = jget_model(CFG), jget_loss(CFG), make_optimizer(CFG, SPE)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(lambda p: loss_fn(model.apply({"params": p}, x), y))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return tx, step


def test_two_steps_match_jax():
    assert "EPIT" not in _TRAIN_FLAG_MODELS
    batches = _batches()
    jparams = jax.jit(jget_model(CFG).init)(jax.random.key(0),
                                            jnp.asarray(batches[0][0][..., None]))["params"]
    tx, jstep = _jax_step()
    jstate = tx.init(jparams)
    trainer = Trainer(CFG, SPE, state_dict_from_flax({"params": jparams}, CFG), device="cpu")
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i, (lr, hr) in enumerate(batches):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(lr[..., None]),
                                       jnp.asarray(hr[..., None]))
        m = trainer.train_step(torch.from_numpy(lr), torch.from_numpy(hr), Draws())
        np.testing.assert_allclose(m["loss"].item(), float(jloss), rtol=1e-5, err_msg=f"step {i}")
        assert np.isfinite(m["psnr"].item()) and -1 <= m["ssim"].item() <= 1
    assert int(trainer.opt_state.count) == 2
    want = state_dict_from_flax({"params": jparams}, CFG)
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    moved = max((got[k] - start[k]).abs().max().item() for k in got)
    assert moved > 1e-4  # the steps moved the parameters
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)

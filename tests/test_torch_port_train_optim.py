"""Port vs JAX: the schedule, the optimizer, masking, augmentation, batch
indices and the block's dropout.

- The schedule against ``make_schedule`` (optax) at every step of a
  warm-up + cosine run; float32 on both sides, 1e-6 relative.
- The optimizer against ``make_optimizer(...).update`` + ``apply_updates``
  over 10 steps that include a clipped step and a NaN step, and past
  ``max_consecutive_errors``: parameters and state, 1e-6 relative (the
  global norm is summed in another order).
- The masking, augmentation and batch-index apply functions on the same
  masks, flags and permutation as JAX (read back from JAX's outputs):
  exact. The draw functions: their invariants.
- The block's dropout: flax's keep rate and scale, only in train mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lfsr_tpu.config import Config
from lfsr_tpu.data import datasets as jdata
from lfsr_tpu.train import masking as jmask
from lfsr_tpu.train import trainer as jtrainer
from lfsr_tpu_torch.bridge import init_params
from lfsr_tpu_torch.data import datasets
from lfsr_tpu_torch.models.lfmambax import dropout
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.train import masking, optim

ANG = 5
SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}


def _rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(1e-30, np.abs(want).max()), err


@pytest.mark.parametrize("warmup_epochs,epochs", [(2, 10), (None, 51)])
def test_schedule_matches_optax_at_every_step(warmup_epochs, epochs):
    cfg = Config(warmup_epochs=warmup_epochs, epochs=epochs)
    spe = 7
    steps = np.arange(epochs * spe + 10)
    want = np.asarray(jax.jit(jax.vmap(jtrainer.make_schedule(cfg, spe)))(jnp.asarray(steps)))
    got = optim.make_schedule(cfg, spe)(torch.as_tensor(steps, dtype=torch.int32))
    assert got.dtype == torch.float32
    _rel(got.numpy(), want, 1e-6)
    assert want[0] == pytest.approx(cfg.lr * 0.01) and want[-1] == pytest.approx(cfg.min_lr)


SHAPES = {"a.weight": (4, 3), "a.bias": (4,), "b.scale": (1,), "c.kernel": (2, 3, 5)}


def _grads(rng, step):
    g = {k: rng.standard_normal(s).astype(np.float32) * 0.05 for k, s in SHAPES.items()}
    if step == 3:  # global norm far above 1: clipped
        g = {k: v * 100 for k, v in g.items()}
    if step == 6:  # a NaN batch: skipped
        g["a.bias"][1] = np.nan
    return g


def _jax_state(st):
    clip_state, (adam, _, sched) = st.inner_state
    return adam, sched


def test_optimizer_matches_optax_with_clip_and_nan_skip():
    cfg = Config(epochs=4, warmup_epochs=1)
    spe = 3
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jtrainer.make_optimizer(cfg, spe)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = tx.init(jp)
    upd = jax.jit(lambda g, s, p: tx.update(g, s, p))
    opt = optim.Optimizer(cfg, spe)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = opt.init(tp)
    for step in range(10):
        g = _grads(rng, step)
        u, jst = upd({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, u)
        before = {k: v.clone() for k, v in tp.items()}
        opt.step_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst)
        adam, sched = _jax_state(jst)
        for k in SHAPES:
            _rel(tp[k].numpy(), jp[k], 1e-6)
            _rel(tst.mu[k].numpy(), adam.mu[k], 1e-6)
            _rel(tst.nu[k].numpy(), adam.nu[k], 1e-6)
            if step == 6:  # no update and no state change on the NaN step
                assert torch.equal(tp[k], before[k])
        assert int(tst.count) == int(adam.count) == int(sched.count) == (step if step >= 6 else step + 1)
        assert int(tst.notfinite_count) == int(jst.notfinite_count)
        assert int(tst.total_notfinite) == int(jst.total_notfinite)
        assert bool(tst.last_finite) == bool(jst.last_finite) == (step != 6)


def test_optimizer_gives_up_after_max_consecutive_errors_as_optax():
    cfg = Config(epochs=4, warmup_epochs=1)
    tx = jtrainer.make_optimizer(cfg, 3)
    upd = jax.jit(lambda g, s, p: tx.update(g, s, p))
    jp = {"w": jnp.ones((2,))}
    jst = tx.init(jp)
    opt = optim.Optimizer(cfg, 3)
    tp = {"w": torch.ones(2)}
    tst = opt.init(tp)
    nan = np.array([np.nan, 1.0], np.float32)
    for _ in range(optim.MAX_CONSECUTIVE_ERRORS + 1):
        u, jst = upd({"w": jnp.asarray(nan)}, jst, jp)
        jp = optax.apply_updates(jp, u)
        opt.step_(tp, {"w": torch.from_numpy(nan)}, tst)
    assert int(tst.notfinite_count) == int(jst.notfinite_count) == 101
    assert int(tst.count) == int(_jax_state(jst)[0].count) == 1  # the last one went through
    np.testing.assert_array_equal(np.isnan(tp["w"].numpy()), np.isnan(np.asarray(jp["w"])))


def test_progressive_ratio_and_view_count_match_jax():
    for epoch in (0, 1, 7, 20, 40):
        r = masking.progressive_ratio(epoch, 0.1, 0.3, 20)
        assert r == jmask.progressive_ratio(epoch, 0.1, 0.3, 20)
        assert masking.num_masked_views(ANG, r) == jmask.num_masked_views(ANG, r)
    assert masking.num_masked_views(ANG, 0.1) == 2


@pytest.mark.parametrize("strategy", ["random", "grid", "corners", "center"])
def test_strategy_order_matches_jax_on_the_same_noise(strategy):
    key = jax.random.key(3)
    want = np.asarray(jmask._strategy_order(key, ANG, strategy))
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (ANG * ANG,))))
    got = masking.strategy_order(noise, ANG, strategy)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[-1] == (ANG // 2) * ANG + ANG // 2  # the centre view is last


def _positive_sai(seed, b=2, h=6, w=6):
    return (np.random.default_rng(seed).random((b, ANG * h, ANG * w, 1)) + 0.5).astype(np.float32)


def test_view_mask_apply_matches_jax_on_the_same_mask():
    x = _positive_sai(0)
    for seed in range(20):  # a key whose batch is not skipped
        out = np.asarray(jmask.mask_views(jax.random.key(seed), jnp.asarray(x), ANG, 2))
        views = out[0, ..., 0].reshape(ANG, 6, ANG, 6)
        keep = (np.abs(views).sum(axis=(1, 3)) > 0).astype(np.float32)
        if keep.sum() == ANG * ANG - 2:
            break
    else:
        raise AssertionError("no masked batch in 20 keys")
    got = masking.apply_view_mask(torch.from_numpy(x), torch.from_numpy(keep), ANG)
    np.testing.assert_array_equal(got.numpy(), out)
    got3 = masking.apply_view_mask(torch.from_numpy(x[..., 0]), torch.from_numpy(keep), ANG)
    np.testing.assert_array_equal(got3.numpy(), out[..., 0])


def test_sracm_apply_matches_jax_on_the_same_mask():
    x = _positive_sai(1)
    out = np.asarray(jmask.sracm(jax.random.key(5), jnp.asarray(x), ANG, 0.3))
    keep = out[0, :6, :6, 0] != 0  # view (0, 0) shows the mask
    assert 0 < keep.sum() < 36
    got = masking.apply_sracm(torch.from_numpy(x), torch.from_numpy(keep), ANG)
    np.testing.assert_array_equal(got.numpy(), out)


def test_augment_apply_matches_jax_on_the_same_flags():
    rng = np.random.default_rng(2)
    lr = rng.random((8, 10, 10)).astype(np.float32)
    hr = rng.random((8, 40, 40)).astype(np.float32)
    jl, jh = map(np.asarray, jdata.augment_batch(jax.random.key(7), jnp.asarray(lr),
                                                  jnp.asarray(hr)))
    flags = np.zeros((3, 8), bool)
    for i in range(8):  # read each item's flags back from JAX's output
        hits = [f for f in np.ndindex(2, 2, 2)
                if np.array_equal(_aug_np(lr[i], f), jl[i])]
        assert len(hits) == 1
        flags[:, i] = hits[0]
    assert flags.any() and not flags.all()
    gl, gh = datasets.apply_augment(torch.from_numpy(lr), torch.from_numpy(hr),
                                    torch.from_numpy(flags))
    np.testing.assert_array_equal(gl.numpy(), jl)
    np.testing.assert_array_equal(gh.numpy(), jh)


def _aug_np(x, f):
    fw, fh, ft = f
    x = x[:, ::-1] if fw else x
    x = x[::-1, :] if fh else x
    return x.T if ft else x


def test_batch_indices_tile_the_permutation_as_jax():
    key = jax.random.key(4)
    want = jdata.batch_indices(key, 10, 4, 7)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 10)))
    np.testing.assert_array_equal(datasets.tile_indices(perm, 4, 7).numpy(), want)


def test_draw_invariants():
    g = torch.Generator().manual_seed(0)
    keeps = [masking.draw_view_mask(g, ANG, 3) for _ in range(200)]
    centre = ANG // 2
    masked = [int((k == 0).sum()) for k in keeps]
    assert all(k[centre, centre] == 1 for k in keeps)
    assert set(masked) == {0, 3} and 60 < masked.count(3) < 140  # skipped half the time
    grid = masking.draw_view_mask(torch.Generator().manual_seed(1), ANG, 12, "grid", 0.0)
    iu, iv = np.divmod(np.arange(ANG * ANG), ANG)
    even = ((iu + iv) % 2 == 0) & (np.arange(ANG * ANG) != centre * ANG + centre)
    np.testing.assert_array_equal(grid.reshape(-1).numpy() == 0, even)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    assert torch.equal(masking.draw_view_mask(g1, ANG, 2), masking.draw_view_mask(g2, ANG, 2))
    sr = masking.draw_sracm(torch.Generator().manual_seed(0), 100, 100, 0.3)
    assert sr.dtype == torch.bool and abs(1 - sr.float().mean().item() - 0.3) < 0.03
    flags = datasets.draw_augment(torch.Generator().manual_seed(0), 4000)
    assert flags.shape == (3, 4000) and abs(flags.float().mean().item() - 0.5) < 0.03
    idx = datasets.batch_indices(torch.Generator().manual_seed(0), 10, 4, 7)
    assert idx.shape == (7, 4) and sorted(idx.reshape(-1)[:10].tolist()) == list(range(10))


def test_one_call_forms_are_draw_then_apply():
    x = torch.from_numpy(_positive_sai(3))
    g = lambda: torch.Generator().manual_seed(4)
    assert torch.equal(masking.mask_views(g(), x, ANG, 2, skip_prob=0.0),
                       masking.apply_view_mask(x, masking.draw_view_mask(g(), ANG, 2, skip_prob=0.0),
                                               ANG))
    assert torch.equal(masking.sracm(g(), x, ANG, 0.3),
                       masking.apply_sracm(x, masking.draw_sracm(g(), 6, 6, 0.3), ANG))
    lr, hr = torch.rand(4, 10, 10), torch.rand(4, 40, 40)
    for a, b in zip(datasets.augment_batch(g(), lr, hr),
                    datasets.apply_augment(lr, hr, datasets.draw_augment(g(), 4))):
        assert torch.equal(a, b)


def test_dropout_keeps_nine_tenths_scaled():
    y = torch.ones(200, 200)
    out = dropout(y, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    np.testing.assert_allclose(out[kept].numpy(), 1 / 0.9, rtol=1e-7)
    assert torch.equal(out, dropout(y, 0.1, torch.Generator().manual_seed(0)))
    # in bfloat16 the scale is 1 / bf16(0.9), rounded to bf16, as flax computes it
    yb = dropout(y.to(torch.bfloat16), 0.1, torch.Generator().manual_seed(0))
    one = torch.ones((), dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16
    assert yb[kept].unique().tolist() == [(one / torch.tensor(0.9, dtype=torch.bfloat16)).item()]


def test_block_dropout_runs_only_in_train_mode():
    cfg = Config(compute_dtype="float32", model_kwargs=SMALL)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.randn(1, 16, 16, 16, generator=torch.Generator().manual_seed(1))
    blk = model.block_0
    with torch.no_grad():
        ref = blk(x)
        blk.train()
        with pytest.raises(ValueError, match="dropout generator"):
            blk(x)
        a = blk(x, torch.Generator().manual_seed(2))
        b = blk(x, torch.Generator().manual_seed(2))
        blk.eval()
        assert torch.equal(blk(x, torch.Generator().manual_seed(2)), ref)
    assert torch.equal(a, b) and not torch.equal(a, ref)

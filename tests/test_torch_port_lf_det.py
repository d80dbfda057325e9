"""Port vs JAX and vs the plain reference: LF-DET's forward, its parameter
tree, its window ops, K15's twin, its tiled eval and a train step, on the
CPU.

One flax param tree (the JAX init at 16 channels with one mix block,
perturbed so the zero biases and unit LayerNorm params are exercised) is
converted by ``bridge.state_dict_from_flax`` and loaded into the port; both
sides see the same numpy input at two geometries: 5 x 5 views of 6 x 6
(MacPI 30: every window side 5, 10 and 15 divides it) and of 7 x 7 (MacPI
35: 10 and 15 take the edge windows and the overlap average; the spatial
reduction's 2x2 stride-2 conv drops the odd row and column, as flax's
'VALID' conv). Every wrapper runs its plain twin on CPU tensors; JAX takes
flax's dense attention.

- float32 SR within 1e-4 of JAX (float32 sums in another order through 21
  Dense layers, the stride-2 conv as a product, the depthwise convs and the
  attentions).
- bfloat16 within 2e-2 of the output scale max(1, max|SR|), the tolerance
  of ``test_torch_port_lft.py``: the frameworks round a bf16 conv, product,
  GELU or softmax at other places (flax's GELU and softmax are chains of
  bf16 ops, PyTorch's one rounding each), so the bf16 head's output differs
  by about one bf16 ulp (1/128 of its magnitude).
- Against ``portbench/reference/lf_det.py`` (plain float32, the windows by
  loops over their starts) on the benchmark's seeded weights: within 1e-5
  of the scale; the reference rounded as a bf16 model in the port's place
  misses that by three orders of magnitude.
- ``macpi_windows`` / ``windows_average`` against slices and adds over the
  JAX module's ``_window_starts``; K15's twin against the formula in
  float64; tiled ``evaluate_sets`` against JAX; one ``Trainer`` step with
  DropPath on; the spans and counters of a forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lfsr_tpu.config import Config
from lfsr_tpu.data.datasets import TestScene as JScene
from lfsr_tpu.models.lf_det import _window_starts
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.train import evaluate as jeval
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import init_params, param_count, state_dict_from_flax
from lfsr_tpu_torch.data.datasets import TestScene, TrainArrays
from lfsr_tpu_torch.models import lf_det
from lfsr_tpu_torch.models.registry import get_model, spec, whole_scene_default
from lfsr_tpu_torch.ops import dense_attention as da
from lfsr_tpu_torch.ops import layout
from lfsr_tpu_torch.train import evaluate as teval
from lfsr_tpu_torch.train.trainer import Trainer
from portbench.harness import data, seeds
from portbench.harness.weights import make_weights
from portbench.reference import lf_det as ref
from portbench.reference.common import Prec

from _torch_port import one_torch_thread  # noqa: F401

SMALL = {"channels": 16, "depth": 1}
SIDES = (6, 7)  # LR view sides: MacPI 30 (windows divide), 35 (edge windows at 10, 15)


def _x(side):
    return np.random.default_rng(5).random((1, 5 * side, 5 * side, 1)).astype(np.float32)


def _cfg(dtype="float32", **kw):
    return Config(model_name="LF_DET", compute_dtype=dtype, model_kwargs=SMALL, **kw)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init at one mix block (its tree does not depend on the
    dtype or the geometry)."""
    return jax.jit(jget_model(_cfg()).init)(jax.random.key(0), jnp.asarray(_x(6)))


def _perturbed(params):
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)


def _port(cfg, state):
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_matches_jax(jax_init, side, dtype, tol):
    cfg = _cfg(dtype)
    x = _x(side)
    params = _perturbed(jax_init)
    want = np.asarray(jax.jit(jget_model(cfg).apply)(params, jnp.asarray(x)))
    model = _port(cfg, state_dict_from_flax(params, cfg))
    calls = []
    wrapped = lf_det.dense_mha

    def spy(q, k, v, heads):
        calls.append((q.shape[1], k.shape[1], heads))
        return wrapped(q, k, v, heads)

    lf_det.dense_mha = spy
    try:
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
    finally:
        lf_det.dense_mha = wrapped
    # two spatial blocks (side^2 queries, (side // 2)^2 keys), three window sizes
    assert calls == [(side**2, (side // 2) ** 2, 4)] * 2 + [(n * n, n * n, 4) for n in (5, 10, 15)]
    assert got.shape == want.shape == (1, 20 * side, 20 * side, 1)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("side", SIDES)
def test_forward_matches_the_reference_and_its_bf16_control_does_not(side):
    weights = make_weights(ref.param_specs(SMALL), 2**31 + 22, "cpu")
    model = _port(_cfg(), weights)
    x = torch.from_numpy(_x(side))
    with torch.inference_mode():
        got = model(x)
        want = ref.forward(weights, x, SMALL)
        control = ref.forward(weights, x, SMALL, q=Prec("bfloat16"))
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    assert (control - want).abs().max().item() > 100 * tol


def test_init_params_matches_the_jax_tree():
    cfg = Config(model_name="LF_DET")  # the registered width: 64 channels, 4 mix blocks
    assert spec("LF_DET").build_loss(cfg).__name__ == "l1" and not whole_scene_default(cfg)
    shapes = jax.eval_shape(jget_model(cfg).init, jax.random.key(0), jnp.zeros((1, 160, 160, 1)))
    n_jax = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes))
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    assert param_count(sd) == n_jax == 1_686_668
    zeros = jax.tree_util.tree_map(lambda l: np.zeros(l.shape, np.float32), shapes)
    mapped = state_dict_from_flax(zeros, cfg)
    assert {k: tuple(v.shape) for k, v in mapped.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    assert {k: s for k, (s, _) in ref.param_specs({}).items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    ln = [k for k in sd if ".LayerNorm_" in k]
    assert len(ln) == 2 * 4 * (2 * 3 + 3 * 2)  # 48 LayerNorms, weight and bias each
    for k in ln:
        assert torch.all(sd[k] == (1.0 if k.endswith("weight") else 0.0)), k


@pytest.mark.parametrize("H,W,ws", [(30, 30, 5), (30, 30, 15), (35, 35, 10), (35, 35, 15),
                                    (160, 160, 15), (20, 35, 15), (12, 9, 5)])
def test_window_ops_match_loops_over_the_starts(H, W, ws):
    x = torch.randn(2, H, W, 3)
    sh, sw = _window_starts(H, ws), _window_starts(W, ws)
    wins = torch.stack([x[:, i : i + ws, j : j + ws] for i in sh for j in sw], 1)
    want = wins.reshape(-1, ws * ws, 3)
    got = layout.macpi_windows(x, ws)
    assert torch.equal(got, want)
    assert layout.window_count(H, W, ws) == (len(sh) * len(sw),
                                             len(sh) * len(sw) - (H // ws) * (W // ws))
    # tokens changed window by window: the overlaps take their mean
    toks = want + torch.arange(want.shape[0], dtype=torch.float32)[:, None, None]
    out = torch.zeros(2, H, W, 3)
    cnt = torch.zeros(1, H, W, 1)
    per = toks.reshape(2, len(sh) * len(sw), ws, ws, 3)
    for n, (i, j) in enumerate((i, j) for i in sh for j in sw):
        out[:, i : i + ws, j : j + ws] += per[:, n]
        cnt[:, i : i + ws, j : j + ws] += 1
    got = layout.windows_average(toks, ws, H, W)
    torch.testing.assert_close(got, out / cnt, rtol=0, atol=1e-6)
    assert cnt.max().item() == (1 if layout.divides(H, W, ws) else
                                (2 if H % ws else 1) * (2 if W % ws else 1))
    # bf16 tokens: summed in float32, one rounding
    got16 = layout.windows_average(toks.bfloat16(), ws, H, W)
    want16 = layout.windows_average(toks.bfloat16().float(), ws, H, W).bfloat16()
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, want16)


@pytest.mark.parametrize("Lq,Lk", [(25, 25), (100, 100), (225, 225), (64, 16), (7, 33)])
def test_the_twin_is_the_formula(Lq, Lk):
    g = torch.Generator().manual_seed(Lq * 1000 + Lk)
    q, k, v = (torch.randn(3, n, 64, generator=g) for n in (Lq, Lk, Lk))
    got = da.dense_mha(q, k, v, 4)  # CPU tensors: the twin
    qd, kd, vd = (t.double().reshape(3, -1, 4, 16) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd / 4.0, kd)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd).reshape(3, Lq, 64)
    assert got.shape == (3, Lq, 64)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        da.dense_mha(q, k[:, :, :32], v[:, :, :32], 4)


def _scene(ang=5, h0=16, s=4):
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0 : h0 * s, 0 : h0 * s] / (h0 * s)
    views = np.empty((ang, ang, h0 * s, h0 * s), np.float32)
    for u in range(ang):
        for v in range(ang):
            views[u, v] = 0.5 + 0.4 * np.sin(6 * (yy + 0.01 * u) + 4 * (xx + 0.01 * v))
    views += 0.01 * rng.standard_normal(views.shape).astype(np.float32)
    lr = views.reshape(ang, ang, h0, s, h0, s).mean(axis=(3, 5))
    sai = lambda a: a.transpose(0, 2, 1, 3).reshape(ang * a.shape[2], ang * a.shape[3])
    return dict(name="toy", dataset="Synthetic", lr_y=sai(lr).astype(np.float32),
                hr_y=sai(views), sr_cbcr=np.zeros((ang * h0 * s, ang * h0 * s, 2), np.float32))


def test_tiled_evaluate_sets_matches_jax(jax_init):
    cfg = _cfg(patch_size_for_test=8, stride_for_test=4, minibatch_for_test=8)
    fields = _scene()
    want = jeval.evaluate_sets(jget_model(cfg).apply, jax_init,
                               {"Synthetic": [JScene(**fields)]}, cfg, log=lambda m: None)
    model = _port(cfg, state_dict_from_flax(jax_init, cfg))
    got = teval.evaluate_sets(model, {"Synthetic": [TestScene(**fields)]}, cfg,
                              log=lambda m: None, keep_views=True)
    assert tuple(got["Synthetic"]["views"]["toy"].shape) == (5, 5, 64, 64)
    assert abs(got["Synthetic"]["psnr"] - want["Synthetic"]["psnr"]) < 1e-3
    assert abs(got["Synthetic"]["ssim"] - want["Synthetic"]["ssim"]) < 1e-4


def test_a_train_step_with_drop_path_and_eval_is_deterministic():
    kw = {"channels": 16, "depth": 2}
    cfg = Config(model_name="LF_DET", compute_dtype="float32", model_kwargs=kw, batch_size=2,
                 seed=123)
    weights = make_weights(ref.param_specs(kw), 2**31 + 23, "cpu")
    lr, hr = data.light_fields(seeds.rng(7, "train_pairs"), 4, (32, 32))
    tr = Trainer(cfg, 1, weights, device="cpu")
    model = tr.model
    assert model.training and max(m.drop for m in model.modules()
                                  if isinstance(m, lf_det._Block)) > 0
    x = torch.from_numpy(lr[:2, ..., None])  # 5 x 5 views of 8 x 8: MacPI 40, edge windows
    with pytest.raises(ValueError):
        model(x)  # train mode draws DropPath from a generator
    gen = lambda n: torch.Generator().manual_seed(n)
    a, b = model(x, generator=gen(1)), model(x, generator=gen(2))
    assert not torch.equal(a, b)  # the rows dropped differ
    loss = (a - torch.from_numpy(hr[:2, ..., None])).abs().mean()
    grads = torch.autograd.grad(loss, list(tr.params.values()), allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(bool((g != 0).any()) for g in grads) == len(grads)
    out = tr.run_epoch(TrainArrays(lr=lr, hr=hr), 0)  # the trainer's step, DropPath on
    assert np.isfinite(out["loss"]) and tr.step == 1
    assert all(torch.isfinite(p).all() for p in tr.params.values())
    model.eval()
    with torch.inference_mode():
        assert torch.equal(model(x), model(x))


def test_a_forward_records_its_spans_and_window_counters():
    cfg = _cfg()
    m = get_model(cfg, device="cpu")
    m.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    x = torch.rand(2, 35, 35, 1)
    with torch.inference_mode():
        m(x)  # the window index tables reach the device once, before the recording
        with profile(activities=[ProfilerActivity.CPU]):
            y = m(x)
    assert y.shape == (2, 140, 140, 1)
    s = trace.summary()
    calls = {k: v["calls"] for k, v in s["spans"].items()}
    want = {"model.input": 1, "model.stem": 1, "model.spa": 2, "model.spa.attn": 2,
            "model.ang": 1, "model.ang.windows": 6, "model.ang.attn": 3, "model.ang.fuse": 1,
            "model.mla": 1, "model.output": 1, "K15": 5, "K13": 12, "K11": 5}
    assert calls == want
    # MacPI 35: 49 windows of 5, 16 of 10 (7 at an edge), 9 of 15 (5 at an edge), 2 maps
    got = {k: n for k, n in s["counts"].items() if k.startswith("lfdet/")}
    assert got == {"lfdet/windows/5": 98, "lfdet/windows/10": 32,
                           "lfdet/windows/15": 18, "lfdet/windows/edge": 24}


@pytest.mark.parametrize("B,Lq,Lk,D,plan", [
    (400, 1024, 256, 64, (64, 1, 256)), (16384, 25, 25, 64, (64, 8, 32)),
    (4096, 100, 100, 64, (64, 2, 128)), (1936, 225, 225, 64, (64, 1, 256)),
    (3, 1024, 1024, 64, (32, 1, 256)), (5, 7, 33, 16, (16, 5, 32))])
def test_k15_plans_the_cells_sites(B, Lq, Lk, D, plan):
    """The tensor-core CTA's channels, packed sequences and query rows: 64
    channels (all 4 heads) at every site of the cell, two CTAs an SM; a
    long Lk stages fewer channels."""
    got = da.mma_plan(B, Lq, Lk, D)
    assert got == plan
    assert da.mma_smem_bytes(Lk, *got) <= (da.PACK_BYTES if got[1] > 1 or Lk <= 256
                                           else da.SMEM_BYTES)
    assert da.kernel_path(torch.bfloat16) == "mma" and da.kernel_path(torch.float32) == "fma"

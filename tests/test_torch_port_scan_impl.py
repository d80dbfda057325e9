"""Port vs JAX: the flagship's ``scan_impl='gated'`` and ``'fused'`` (K9b, K9c).

The JAX side runs as its own tests run it on the CPU: ``scan_gated_fused``
and ``mamba_inner_fused`` are Pallas kernels in interpret mode (automatic
off the TPU), ``scan_gated_ref``/``mamba_inner_ref`` their references, and
JAX's CPU ``Mamba`` always takes ``mamba_inner_ref``. So the port's
``Mamba`` is also held against a JAX composition of the TPU branch
(``ssm.py:99-153``) built here from the same flax params.

Tolerances, each against max(1, max|want|) unless said otherwise:
- K9b twin vs the Pallas kernel, float32 1e-4 (the scan's sums in another
  order); z and W_out in bf16 2e-2 (one bf16 rounding of y and of the
  output);
- K9c twin vs ``mamba_inner_ref`` and the kernel, float32 1e-5 absolute
  (the bound JAX's own test puts between the two);
- gradients vs ``jax.grad`` 2e-4 absolute (float32 backward through the scan);
- ``Mamba`` vs the JAX composition float32 1e-5, bf16 2e-2; vs JAX's own
  ``Mamba`` float32 1e-4;
- the small flagship vs JAX float32 2e-5, bf16 2e-2 absolute (as
  ``test_torch_port_model.py``), also under ``'assoc'`` (JAX's opt-in for
  the pure reference, ``mamba_inner_ref`` on any backend; the port's
  ``mamba_inner_plain``, no scan kernel); whole-scene PSNR 1e-3 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfsr_tpu.config import Config as JConfig
from lfsr_tpu.data.datasets import TestScene as JScene
from lfsr_tpu.models.registry import get_model as jget_model
from lfsr_tpu.models.ssm import Mamba as JMamba
from lfsr_tpu.ops import pallas_layout as jpl
from lfsr_tpu.ops import pallas_scan as jps
from lfsr_tpu.train import evaluate as jeval
from lfsr_tpu_torch import trace
from lfsr_tpu_torch.bridge import _MAMBA, state_dict_from_flax
from lfsr_tpu_torch.config import Config
from lfsr_tpu_torch.data.datasets import TestScene
from lfsr_tpu_torch.models.registry import get_model
from lfsr_tpu_torch.models.ssm import Mamba
from lfsr_tpu_torch.ops import scan
from lfsr_tpu_torch.train.evaluate import evaluate_sets
from lfsr_tpu_torch.train.trainer import Trainer

from _torch_port import one_torch_thread  # noqa: F401

SMALL = {"channels": 16, "d_state": 4, "phases": ((2, 0.25), (1, None))}
F32_TOL, BF16_TOL = 2e-5, 2e-2


@pytest.fixture
def layout_interpret():
    jpl.FORCE_KERNEL_INTERPRET = True
    yield
    jpl.FORCE_KERNEL_INTERPRET = False


def _rn(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _gated_inputs(seed, B=2, L=256, Di=8, N=4, Dout=6):
    """u, delta, A, Bc, Cc, z, D_skip, W_out (delta pre- or post-softplus:
    the same numbers serve both)."""
    rng = np.random.default_rng(seed)
    return (_rn(rng, B, L, Di, s=0.5), _rn(rng, B, L, Di, s=0.5),
            -np.abs(_rn(rng, Di, N)) - 0.1, _rn(rng, B, L, N, s=0.5), _rn(rng, B, L, N, s=0.5),
            _rn(rng, B, L, Di), 1 + _rn(rng, Di, s=0.1), _rn(rng, Di, Dout, s=Di**-0.5))


def _inner_inputs(seed, B=2, L=256, Di=16, N=4, R=2, K=4):
    """xs, z, wconv, bconv, Wx, Wdt, bdt, A, D_skip (as JAX's own test)."""
    rng = np.random.default_rng(seed)
    return (_rn(rng, B, L, Di), _rn(rng, B, L, Di), _rn(rng, K, Di, s=0.2), _rn(rng, Di, s=0.1),
            _rn(rng, Di, R + 2 * N, s=0.1), _rn(rng, R, Di, s=0.2), _rn(rng, Di, s=0.1),
            -np.abs(_rn(rng, Di, N)) - 0.1, np.ones(Di, np.float32))


def _cast(arrs, idx, jdt, tdt):
    """(jax arrays, torch tensors), the arguments at ``idx`` in the given dtypes."""
    j = [jnp.asarray(a, jdt if i in idx else jnp.float32) for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(tdt if i in idx else torch.float32) for i, a in enumerate(arrs)]
    return j, t


# (a) K9b's twin vs the Pallas kernel --------------------------------------

@pytest.mark.parametrize("pre_softplus", [False, True], ids=["delta", "dt_raw"])
def test_k9b_twin_matches_pallas_kernel_f32(pre_softplus):
    args = _gated_inputs(0)
    if not pre_softplus:
        args = (args[0], np.log1p(np.exp(args[1])), *args[2:])
    j, t = _cast(args, (), jnp.float32, torch.float32)
    want = jps.scan_gated_fused(*j, 64, pre_softplus)
    got = scan.scan_gated_plain(*t, pre_softplus)
    assert got.dtype == torch.float32 and got.shape == (2, 256, 6)
    _assert_rel(got.numpy(), want, 1e-4)
    _assert_rel(got.numpy(), jps.scan_gated_ref(*j, pre_softplus=pre_softplus), 1e-4)


def test_k9b_twin_matches_pallas_kernel_bf16_gate_and_wout():
    j, t = _cast(_gated_inputs(1), (5, 7), jnp.bfloat16, torch.bfloat16)
    want = jps.scan_gated_fused(*j, 64, True)
    got = scan.scan_gated_plain(*t, True)
    assert got.dtype == torch.float32
    _assert_rel(got.numpy(), np.asarray(want, np.float32), 2e-2)


# (b) K9c's twin vs the reference and the Pallas kernel ---------------------

def test_k9c_twin_matches_reference_and_pallas_kernel():
    j, t = _cast(_inner_inputs(2), (), jnp.float32, torch.float32)
    got = scan.mamba_inner_plain(*t).numpy()
    assert got.shape == (2, 256, 16)
    for want in (jps.mamba_inner_ref(*j), jps.mamba_inner_fused(*j)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


# (c) the CPU wrappers take their twins and count nothing -------------------

def test_cpu_wrappers_take_their_twins_without_counting():
    gargs = [torch.from_numpy(a) for a in _gated_inputs(3, L=100)]
    iargs = [torch.from_numpy(a) for a in _inner_inputs(4, L=100)]
    before = (trace.counter("launches/K9b"), trace.counter("launches/K9c"))
    for fused, plain, args in ((scan.scan_gated_fused, scan.scan_gated_plain, (*gargs, True)),
                               (scan.mamba_inner_fused, scan.mamba_inner_plain, iargs)):
        np.testing.assert_array_equal(fused(*args).numpy(), plain(*args).numpy())
    assert (trace.counter("launches/K9b"), trace.counter("launches/K9c")) == before


# (d) PlainVJP gradients vs jax.grad ----------------------------------------

@pytest.mark.parametrize("name", ["K9b", "K9c"])
def test_gradients_match_jax_grad(name):
    if name == "K9b":
        args = _gated_inputs(5, B=1, L=128, Di=4, N=2, Dout=3)
        jfn = lambda *a: jps.scan_gated_fused(*a, 64, True)
        tfn = lambda *a: scan.scan_gated_fused(*a, True)
    else:
        args = _inner_inputs(6, B=1, L=128, Di=4, N=2, R=1)
        jfn, tfn = jps.mamba_inner_fused, scan.mamba_inner_fused
    cot = np.random.default_rng(7).standard_normal(np.shape(jfn(*map(jnp.asarray, args))))
    cot = cot.astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(tfn(*leaves), leaves, torch.from_numpy(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)


# (e) the port's Mamba vs the TPU branch composed in JAX ----------------------

def _mamba_pair(impl, dtype, seed=8):
    """A perturbed flax Mamba (d_model 16, d_state 4, expand 1.25: Di 20,
    R 1) and the port's Mamba under ``impl`` with the same parameters."""
    jm = JMamba(d_model=16, d_state=4, d_conv=4, expand=1.25, dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 128, 16)))["params"]
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()}
    tm = Mamba(16, 4, 4, 1.25, scan_impl=impl, dtype=getattr(torch, dtype), device="cpu")
    tm.load_state_dict({name: torch.from_numpy(np.array(fn(params[leaf])))
                        for leaf, (name, fn) in _MAMBA.items()})
    return params, tm


def _jax_tpu_branch(p, x, impl, dt):
    """ssm.py:99-153 as the TPU runs it, with the Pallas kernels in
    interpret mode: 'gated' pads L to a multiple of 128 and runs
    scan_gated_fused; 'fused' runs mamba_inner_fused (L % 128 == 0)."""
    R, N = p["dt_proj_kernel"].shape[0], p["A_log"].shape[1]
    xz = x.astype(dt) @ p["in_proj_kernel"].astype(dt)
    xs, z = jnp.split(xz, 2, axis=-1)
    A = -jnp.exp(p["A_log"])
    if impl == "fused":
        y = jps.mamba_inner_fused(xs, z, p["conv1d_kernel"][:, 0, :], p["conv1d_bias"],
                                  p["x_proj_kernel"], p["dt_proj_kernel"], p["dt_proj_bias"],
                                  A, p["D"])
        return y.astype(dt) @ p["out_proj_kernel"].astype(dt)
    xc = JMamba._conv_silu(xs, p["conv1d_kernel"], p["conv1d_bias"], dt)
    dbc = xc @ p["x_proj_kernel"].astype(dt)
    L = xs.shape[1]
    Lp = -(-L // 128) * 128
    pad = lambda a: jnp.pad(a, ((0, 0), (0, Lp - L), (0, 0)))
    xc, dbc, z = pad(xc), pad(dbc), pad(z)
    dt_raw = dbc[..., :R] @ p["dt_proj_kernel"].astype(dt) + p["dt_proj_bias"].astype(dt)
    out = jps.scan_gated_fused(xc, dt_raw, A, dbc[..., R : R + N], dbc[..., R + N :], z,
                               p["D"], p["out_proj_kernel"].astype(dt),
                               256 if Lp % 256 == 0 else 128, True)
    return out[:, :L]


@pytest.mark.parametrize("impl,dtype,L", [("gated", "float32", 256), ("gated", "float32", 200),
                                          ("gated", "bfloat16", 256),
                                          ("fused", "float32", 256), ("fused", "bfloat16", 256)])
def test_mamba_matches_the_tpu_branch(impl, dtype, L):
    params, tm = _mamba_pair(impl, dtype)
    x = np.random.default_rng(9).standard_normal((2, L, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(_jax_tpu_branch(jp, jnp.asarray(x), impl, getattr(jnp, dtype)), np.float32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, L, 16)
    _assert_rel(got.float().numpy(), want, 1e-5 if dtype == "float32" else 2e-2)
    if dtype == "float32":  # JAX's own CPU Mamba: mamba_inner_ref
        own = JMamba(d_model=16, d_state=4, d_conv=4, expand=1.25, dtype=jnp.float32)
        _assert_rel(got.numpy(), own.apply({"params": jp}, jnp.asarray(x)), 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_under_assoc_matches_jax(dtype):
    """'assoc' is JAX's ``mamba_inner_ref`` + out_proj on every backend; the
    port's is ``mamba_inner_plain`` + out_proj and counts no launch."""
    params, tm = _mamba_pair("assoc", dtype)
    x = np.random.default_rng(10).standard_normal((2, 256, 16)).astype(np.float32)
    jm = JMamba(d_model=16, d_state=4, d_conv=4, expand=1.25, dtype=getattr(jnp, dtype),
                scan_impl="assoc")
    want = np.asarray(jm.apply({"params": {k: jnp.asarray(v) for k, v in params.items()}},
                               jnp.asarray(x)), np.float32)
    launches = (trace.counter("launches/K9b"), trace.counter("launches/K9c"),
                trace.counter("launches/K1"))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert (trace.counter("launches/K9b"), trace.counter("launches/K9c"),
            trace.counter("launches/K1")) == launches
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 256, 16)
    _assert_rel(got.float().numpy(), want, 1e-5 if dtype == "float32" else 2e-2)


# (f) the small flagship under each scan_impl vs JAX LFMambaX ----------------

def _perturbed_params(cfg, x):
    params = jax.jit(jget_model(cfg).init)(jax.random.key(0), jnp.asarray(x))
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(l) + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(tdef, leaves)


@pytest.fixture(scope="module")
def small_params():
    x = np.random.default_rng(0).random((2, 40, 40, 1)).astype(np.float32)
    return x, _perturbed_params(JConfig(compute_dtype="float32", model_kwargs=SMALL), x)


@pytest.mark.parametrize("impl", ["gated", "fused", "assoc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_flagship_matches_jax(small_params, layout_interpret, impl, dtype):
    x, params = small_params
    kw = {**SMALL, "scan_impl": impl}
    want = np.asarray(jax.jit(jget_model(JConfig(compute_dtype=dtype, model_kwargs=kw)).apply)(
        params, jnp.asarray(x)))
    cfg = Config(compute_dtype=dtype, model_kwargs=kw)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    launches = (trace.counter("launches/K9b"), trace.counter("launches/K9c"))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert (trace.counter("launches/K9b"), trace.counter("launches/K9c")) == launches
    assert got.dtype == torch.float32 and got.shape == (2, 160, 160, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_TOL if dtype == "float32" else BF16_TOL)


def test_whole_scene_eval_under_gated_matches_jax(small_params):
    _, params = small_params
    kw = {**SMALL, "scan_impl": "gated"}
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    views = np.stack([0.5 + 0.4 * np.sin(6 * yy + 4 * xx + 0.05 * i) for i in range(25)])
    views = (views.reshape(5, 5, 64, 64) + 0.01 * rng.standard_normal((5, 5, 64, 64)))
    lr = views.reshape(5, 5, 16, 4, 16, 4).mean(axis=(3, 5))
    sai = lambda a: a.transpose(0, 2, 1, 3).reshape(5 * a.shape[2], 5 * a.shape[3])
    fields = dict(name="s0", dataset="Synthetic", lr_y=sai(lr).astype(np.float32),
                  hr_y=sai(views).astype(np.float32),
                  sr_cbcr=np.full((320, 320, 2), 0.5, np.float32))
    jcfg = JConfig(compute_dtype="float32", model_kwargs=kw)
    want = jeval.evaluate_sets(jget_model(jcfg).apply, params, {"Synthetic": [JScene(**fields)]},
                               jcfg, log=lambda m: None)
    cfg = Config(compute_dtype="float32", model_kwargs=kw)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg))
    got = evaluate_sets(model, {"Synthetic": [TestScene(**fields)]}, cfg, log=lambda m: None)
    assert np.isfinite(got["Synthetic"]["psnr"])
    assert abs(got["Synthetic"]["psnr"] - want["Synthetic"]["psnr"]) < 1e-3


# (g) what is not ported raises -----------------------------------------------

@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_unported_scan_impl_raises(impl):
    cfg = Config(model_kwargs={**SMALL, "scan_impl": impl})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(cfg, device="cpu")


# (h) the entry points default to the card -------------------------------------

def test_bare_entry_points_target_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a bare get_model builds there")
    cfg = Config(model_kwargs=SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg)
    sd = {k: torch.zeros(v.shape) for k, v in get_model(cfg, device="meta").state_dict().items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, 1, sd)
    assert next(get_model(cfg, device="cpu").parameters()).device.type == "cpu"

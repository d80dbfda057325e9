"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, run in parallel) and linked into ONE shared library
with a plain C interface, the first time a kernel is launched, and loaded
with ``ctypes``. The library goes to
``lfsr_tpu_torch/_build/`` (git-ignored) under a name that hashes the
sources, so an edited source rebuilds and an unchanged one is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code. Nothing
here imports or initialises CUDA at import time: the CPU tests import
every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from lfsr_tpu_torch import trace

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.c_longlong  # a row stride or a row count
# C signatures of the entry points (each returns a cudaError_t as int)
_SIGNATURES = {
    # K1/K2's passes. u, dbc, wdt, bdt, A, hloc, dsum, B, L, Di, R, N, Tc,
    # dtype, stream
    "lfsr_chunk_scan_summaries": [_P] * 7 + [_I] * 7 + [_P],
    # A, hloc, dsum, B, Di, N, chunks, stream
    "lfsr_chunk_scan_carry": [_P] * 3 + [_I] * 4 + [_P],
    # u, dbc, wdt, bdt, A, D, hloc, y, states, B, L, Di, R, N, Tc, spacing,
    # dtype, stream
    "lfsr_chunk_scan_outputs": [_P] * 9 + [_I] * 8 + [_P],
    # K3's passes. dbc, dy, wdt, bdt, A, mloc, dsum, B, L, Di, R, N, spacing,
    # dtype, stream
    "lfsr_scan_adjoint_summaries": [_P] * 7 + [_I] * 7 + [_P],
    # u, dbc, dy, wdt, bdt, A, states, mloc, du, ddt, dB, dC, dA_chunks, B, L,
    # Di, R, N, spacing, dtype, stream
    "lfsr_scan_adjoint": [_P] * 13 + [_I] * 7 + [_P],
    # part, out, B, parts, inner, stream
    "lfsr_sum_parts": [_P] * 2 + [_I] * 3 + [_P],
    # u, dbc, delta, B, sB, C, sC, z, sz, y, wdt, bdt, A, D,
    # B, L, Di, R, N, mode, u dtype, gate dtype, stream
    "lfsr_scan_gate": [_P] * 3 + [_P, _S] * 3 + [_P] * 5 + [_I] * 8 + [_P],
    # x, w, out, rows, K, M, dtype, stream
    "lfsr_rows_matmul": [_P] * 3 + [_S] + [_I] * 3 + [_P],
    # xs, sxs, wconv, bconv, wx, xc, dbc, B, L, Di, KC, J, dtype, stream
    "lfsr_mamba_front": [_P, _S] + [_P] * 5 + [_I] * 6 + [_P],
    # x, gamma, beta, out, B, H, W, C, eps, dtype, stream
    "lfsr_cross_scan_gather": [_P] * 4 + [_I] * 4 + [_F, _I, _P],
    # x, gamma, beta, out, B, H, W, C, positions a tile, eps, dtype, stream
    "lfsr_cross_scan_gather_tile": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    # seq, x, w, scale, out, B, H, W, C, dtype, stream
    "lfsr_cross_scan_scatter": [_P] * 5 + [_I] * 5 + [_P],
    # seq, x, w, scale, out, B, H, W, C, tile rows, tile columns, stream
    "lfsr_cross_scan_scatter_mma": [_P] * 5 + [_I] * 6 + [_P],
    # x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C, ws, heads,
    # qscale, eps, dtype, stream
    "lfsr_window_mha": [_P] * 8 + [_I] * 6 + [_F, _F, _I, _P],
    # x, wqkv, wout, ln_g, ln_b, bias, scale, y, B, H, W, C, heads, qscale,
    # eps, CTAs, windows a CTA, shared-memory bytes, dtype, stream
    "lfsr_window_mha_mma": [_P] * 8 + [_I] * 5 + [_F, _F, _I, _I, _S, _I, _P],
    # x, gamma, beta, whm, wrest, wk, xn, local, B, H, W, C, c4, slope, eps,
    # x dtype, dtype (of the weights and outputs), stream
    "lfsr_ln_msl": [_P] * 8 + [_I] * 5 + [_F, _F, _I, _I, _P],
    # q, k, v, mask transposed, o, B, L, D, heads, qscale, dtype, stream
    "lfsr_masked_mha": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    # q, k, v, mask (row-major), o, B, L, D, heads, qscale, stream
    "lfsr_masked_mha_mma": [_P] * 5 + [_I] * 4 + [_F, _P],
    # u, delta, B, sB, C, sC, y, A, D (or null), B, L, Di, N, mode, dtype, stream
    "lfsr_scan_given": [_P, _P] + [_P, _S] * 2 + [_P] * 3 + [_I] * 6 + [_P],
    # y, w1, w36, bias, out, B, H, W, C, Cz, tile rows, tile columns, slope,
    # dtype, stream
    "lfsr_hlfr_tail": [_P] * 5 + [_I] * 7 + [_F, _I, _P],
    # x, w, bias (or null), y, B, H, W, C, kh, kw, dh, dw, channels a staged
    # tile, tile rows, tile columns, staged tiles, rounding, dtype, stream
    "lfsr_depthwise": [_P] * 4 + [_I] * 14 + [_P],
    # q, k, v, o, B, h, w, D, heads, k_r, k_c, qscale, stream (K12: bf16 on the
    # tensor cores, float32 on the CUDA cores)
    "lfsr_local_mha_mma": [_P] * 4 + [_I] * 7 + [_F, _P],
    "lfsr_local_mha": [_P] * 4 + [_I] * 7 + [_F, _P],
    # x, add (or null), gamma, beta, out, rows, C, period, eps, x dtype, add
    # dtype (-1: no addend), out dtype, stream (K13)
    "lfsr_layer_norm": [_P] * 5 + [_S] + [_I] * 2 + [_F] + [_I] * 3 + [_P],
    # xs, its row stride, wconv, its two strides, bconv, xc, B, L, Di, K, run,
    # lanes a CTA, runs a CTA, grid x, grid y, vec, dtype, stream (K14)
    "lfsr_conv_silu": [_P, _S, _P, _S, _S, _P, _P] + [_I] * 11 + [_P],
    # q, k, v, o, B, Lq, Lk, D, k/v row spacing, heads, qscale, dtype, stream
    # (K15 on the CUDA cores)
    "lfsr_dense_mha": [_P] * 4 + [_I] * 6 + [_F, _I, _P],
    # q, k, v, o, B, Lq, Lk, D, k/v row spacing, channels, sequences and
    # query rows a CTA, qscale, stream (K15 on the tensor cores)
    "lfsr_dense_mha_mma": [_P] * 4 + [_I] * 8 + [_F, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the Hopper "
        "kernels are built from lfsr_tpu_torch/csrc at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblfsr_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library (no-op if it exists).

    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report (registers,
    shared memory and spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    ptxas = ["-Xptxas", "-v"] if verbose else []
    # one nvcc per source, all started together, then one link
    cmds = [[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    results = [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(cmds, procs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in results):
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        results.append((link, res.stdout, res.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if verbose:
        print("".join(text for _, text, _ in results))
    for cmd, text, rc in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.lfsr_error_string.argtypes = [ctypes.c_int]
        handle.lfsr_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call a C entry point; raise if it reports a CUDA error."""
    handle = lib()
    err = getattr(handle, name)(*args)
    if err != 0:
        msg = handle.lfsr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of the card ``t`` lies on."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


# --------------------------------------------------------------------------
# kernel / plain-twin dispatch
# --------------------------------------------------------------------------

# Switch: run every wrapper's plain twin even on CUDA tensors, so a whole
# forward can be compared kernel-vs-twin on the card (tests, chip_smoke),
# or on meta tensors, so ``tools.efficiency`` can run the model for shapes
# alone. The package sets it nowhere else.
_FORCE_PLAIN = False


@contextlib.contextmanager
def force_plain():
    """Within this block every kernel wrapper runs its plain twin."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def use_plain(t: torch.Tensor) -> bool:
    """True when a wrapper must take its plain twin: the tensor lies on the
    CPU (or the test-only :func:`force_plain` is active). A CUDA tensor
    returns False — the wrapper then launches its kernel or raises."""
    if t.device.type == "cpu" or _FORCE_PLAIN:
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def twin_error(got, want) -> tuple[float, float]:
    """A kernel's output(s) ``got`` against its twin's ``want`` (a tensor
    or a tuple of them): max |got - want| and the bound's scale
    max(1, max |want|)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    return err, max(1.0, *(b.float().abs().max().item() for b in want))


def _check_meta(t: torch.Tensor, name: str, shape, dtype, device):
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def check(t: torch.Tensor, name: str, shape=None, dtype=None, device=None):
    """Validate a kernel operand: CUDA, dtype, shape, contiguous."""
    _check_meta(t, name, shape, dtype, device)
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def row_spacing(t: torch.Tensor) -> int | None:
    """The row stride, in elements, of a [B, L, X] tensor whose rows are
    unit-stride and evenly spaced (a contiguous tensor, or a slice of a
    wider tensor's last axis, as B and C of dbc or z of in_proj's output:
    batch stride L rows); None for any other layout."""
    B, L, X = t.shape
    s0, s1, s2 = t.stride()
    if L == 1:
        s1 = s0 if B > 1 else X
    if (X > 1 and s2 != 1) or (B > 1 and s0 != L * s1) or s1 < X:
        return None
    return s1


def row_stride(t: torch.Tensor, name: str, shape, dtype=None, device=None) -> int:
    """Validate a [B, L, X] kernel operand whose rows may be spaced
    (:func:`row_spacing`). Returns the row stride in elements."""
    _check_meta(t, name, shape, dtype, device)
    s = row_spacing(t)
    if s is None:
        raise ValueError(f"{name}: rows must be unit-stride and evenly spaced, "
                         f"got strides {t.stride()}")
    return s


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def counted(kernel: str, paths: tuple = ()):
    """Give a kernel wrapper its span ``kernel`` (``trace.span``; ``fn.kernel``
    names it) and its launch counters in the trace table, ``launches/<K>``
    and ``launches/<K>/<path>`` for each of its kernels, which
    :func:`launched` counts."""
    trace.declare(f"launches/{kernel}", *(f"launches/{kernel}/{p}" for p in paths))

    def wrap(fn):
        out = trace.span(kernel)(fn)
        out.kernel = kernel
        return out

    return wrap


def launched(kernel: str, path: str | None = None) -> None:
    """Count one launch of wrapper ``kernel`` (through ``path``, one of its
    kernels, where it has two)."""
    trace.count(f"launches/{kernel}")
    if path is not None:
        trace.count(f"launches/{kernel}/{path}")


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

def wants_grad(*tensors) -> bool:
    """True when autograd records and some operand requires a gradient:
    the wrapper then goes through its autograd Function."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class PlainVJP(torch.autograd.Function):
    """``fwd(*args)`` (a kernel, or its twin on the CPU) with the gradient
    of ``plain(*args)``: backward recomputes the plain twin from the saved
    inputs under ``enable_grad`` and returns ``torch.autograd.grad`` of it,
    inside the span ``vjp.<kernel>``.
    This is what the JAX custom_vjps of K4-K7 do (they differentiate the XLA
    reference; the TPU has no backward kernel for them).

        PlainVJP.apply(kernel, fwd, plain, *args)
    """

    @staticmethod
    def forward(ctx, kernel, fwd, plain, *args):
        ctx.kernel, ctx.plain = kernel, plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.consts = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a, t in zip(args, ctx.is_tensor) if t))
        return fwd(*args)

    @staticmethod
    def backward(ctx, *grads):
        with trace.span("vjp." + ctx.kernel):
            saved = iter(ctx.saved_tensors)
            need = ctx.needs_input_grad[3:]
            args = [next(saved).detach().requires_grad_(nd) if t else c
                    for t, c, nd in zip(ctx.is_tensor, ctx.consts, need)]
            wrt = [a for a, nd in zip(args, need) if nd]
            with torch.enable_grad():
                outs = ctx.plain(*args)
                outs = outs if isinstance(outs, tuple) else (outs,)
                pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
                got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                               [g for _, g in pairs], allow_unused=True))
            return (None, None, None, *(next(got) if nd else None for nd in need))

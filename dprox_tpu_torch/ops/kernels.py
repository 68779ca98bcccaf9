"""Hand-written Hopper kernels of the port, their wrappers and plain versions.

Each kernel replaces one Pallas TPU kernel of dprox_tpu/ops/pallas_kernels.py:

* ``tv_denoise_chw`` (csrc/tv_denoise.cu) <- ``tv_denoise_chw_pallas``:
  every TV dual-ascent iteration in one launch, the state in registers;
* ``freq_divide`` (csrc/freq_divide.cu) <- ``freq_divide``: the
  frequency-diagonal divide of the x-update, by a real divisor or (a second
  entry) by a complex one;
* ``fused_admm_update`` (csrc/fused_admm_update.cu) <- ``fused_admm_update``:
  the nonneg / soft-threshold prox and the ADMM dual update in one pass;
* ``bdot`` (csrc/bdot.cu) <- ``bdot_pallas``: per-batch dot products, a
  short row in one block and one launch, a long row over blocks spread
  over the card and a dependent launch that adds their partial sums;
  deterministic;
* ``fused_cg_tail`` (csrc/cg_tail.cu) <- ``fused_cg_tail``: one CG
  iteration minus the matvec (both reductions and the three axpys) in
  three dependent launches;
* ``bsr_matvec`` (csrc/bsr_matvec.cu) and ``csr_matvec``
  (csrc/csr_matvec.cu) <- ``bsr_matvec``: the sparse matrix-vector product
  of the LP path, float32 and float64, over dense tiles or over compressed
  rows, whichever moves fewer bytes for the operator
  (``algo.lp.utils.BSRMat.route``). The compressed kernel cuts its work by
  non-zeros, once, when the operator is built (``csr_split``).

One source replaces no TPU kernel: ``csrc/mosaic_pcg.cu``, the stages of
the preconditioned CG x-update on ``mosaic(conv(x))`` between its cuFFT
calls (``mcg_*``, linalg/structured.py), one pass a stage.

The sources in ``csrc/`` are CUDA C++ for ``sm_90a`` with a plain C
interface (``reduce.cuh`` is the header ``bdot.cu``, ``cg_tail.cu`` and
``csr_matvec.cu`` share). ``build()`` compiles each into its own shared
library with ``nvcc`` (all sources at once, in parallel) under
``build/kernels/`` at first use, and the wrappers call them through
``ctypes`` with ``data_ptr()`` pointers on PyTorch's current stream. A
wrapper takes the plain PyTorch version only for CPU tensors; for a CUDA
tensor it launches its kernel or raises. Each wrapper counts its launches in its
``launches`` attribute.

Gradients: on CPU tensors the plain versions are differentiable as they
are. On the card, where grad is enabled and an input requires it, each
wrapper but the sparse products runs as a ``torch.autograd.Function``
whose forward is the kernel (the same one launch). ``tv_denoise_chw``'s
backward is a kernel too, ``tv_denoise_chw_vjp`` (csrc/tv_denoise.cu): the
forward writes each dual's clip branch per iteration and the backward runs
every step of the adjoint recursion from them in one windowed launch, then
adds d lam's partial sums in a second; its plain version
``tv_denoise_chw_vjp_plain`` is the same recursion in tensor ops (the JAX
package differentiates its jnp reference; the Pallas kernel has no VJP).
The others' backwards are written in PyTorch ops, as the JAX package
differentiates its jnp references: the closed-form VJPs
``freq_divide_vjp``, ``fused_admm_update_vjp`` (a tie takes half, as
``jnp.maximum`` gives) and ``fused_cg_tail_vjp``, and ``bdot``'s products.
``BSRMat`` gives the sparse products their backward (the transposed
apply). Each Function's backward runs inside ``span("dprox.vjp")`` and adds
one to the counter ``ops.vjps`` (utils/profiling.py ``vjp_span``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.tv import _clip, _dh_w, _dht_w, _dv_w, _dvt_w, _lam, tv_denoising_chw
from ..utils.profiling import vjp_span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"tv_denoise": "tv_denoise.cu", "freq_divide": "freq_divide.cu",
           "fused_admm_update": "fused_admm_update.cu", "bdot": "bdot.cu",
           "cg_tail": "cg_tail.cu", "bsr_matvec": "bsr_matvec.cu",
           "csr_matvec": "csr_matvec.cu", "mosaic_pcg": "mosaic_pcg.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "tv_denoise": {
        "dprox_tv_denoise_chw": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
        "dprox_tv_max_iterations": [],
        "dprox_tv_window": [_I, _I, _I, _I],
        "dprox_tv_vjp_window": [_I, _I, _I, _I],
        "dprox_tv_vjp_workspace": [_I, _I, _I, _I, _I],
        "dprox_tv_vjp": [_P, _P, _LL, _LL, _LL, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "dprox_tv_kernel_attributes": [_I, _I, _P, _P, _P],
    },
    "freq_divide": {
        "dprox_freq_divide": [_P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _LL,
                              _P, _I, _F, _P, _I, _I, _I, _I, _P],
        "dprox_freq_divide_c64": [_P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _LL,
                                  _P, _I, _F, _P, _I, _I, _I, _I, _P],
    },
    "fused_admm_update": {
        "dprox_fused_admm_update": [_P, _P, _P, _I, _I, _P, _P, _LL, _LL, _P],
    },
    "bdot": {
        "dprox_bdot": [_P, _P, _P, _P, _I, _LL, _I, _P],
        "dprox_bdot_f64": [_P, _P, _P, _P, _I, _LL, _I, _P],
        "dprox_bdot_workspace": [_I, _LL, _I],
    },
    "cg_tail": {
        "dprox_cg_tail": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _P],
        "dprox_cg_tail_workspace": [_I, _LL],
    },
    "bsr_matvec": {
        "dprox_bsr_matvec": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "csr_matvec": {
        "dprox_csr_matvec": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P],
    },
    "mosaic_pcg": {
        "dprox_mcg_otf_apply": [_P, _P, _I, _I, _I, _LL, _I, _P],
        "dprox_mcg_mask": [_P, _F, _I, _I, _I, _I, _I, _P],
        "dprox_mcg_gram": [_P, _P, _P, _I, _I, _F, _P, _P, _I, _I, _LL, _I, _P],
        "dprox_mcg_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _P],
        "dprox_mcg_precond": [_P, _P, _I, _I, _I, _LL, _I, _P],
        "dprox_mcg_real": [_P, _F, _P, _I, _I, _LL, _I, _P],
        "dprox_mcg_direction": [_P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _LL, _I, _P],
        "dprox_mcg_start": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _P],
        "dprox_mcg_residual": [_P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _I, _I, _LL,
                               _I, _P],
    },
}
_ERROR_STRING = {"tv_denoise": "dprox_tv_error_string",
                 "freq_divide": "dprox_freq_divide_error_string",
                 "fused_admm_update": "dprox_fused_admm_update_error_string",
                 "bdot": "dprox_bdot_error_string",
                 "cg_tail": "dprox_cg_tail_error_string",
                 "bsr_matvec": "dprox_bsr_matvec_error_string",
                 "csr_matvec": "dprox_csr_matvec_error_string",
                 "mosaic_pcg": "dprox_mcg_error_string"}

_RESTYPES = {"dprox_tv_vjp_workspace": ctypes.c_longlong}  # the others return int

_libs: dict = {}  # name -> loaded ctypes.CDLL


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin); it builds the port's kernels")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names=None) -> dict:
    """Compile the kernels that are not built yet, one ``nvcc`` per source,
    all started together. Returns per kernel ``{"seconds", "cached",
    "ptxas"}`` (ptxas: the compiler's register/shared-memory report)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            report[name] = {"seconds": 0.0, "cached": True, "ptxas": []}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)
        ptxas = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln or "spill" in ln]
        report[name] = {"seconds": seconds, "cached": False, "ptxas": ptxas}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
        err_fn = getattr(lib, _ERROR_STRING[name])
        err_fn.argtypes, err_fn.restype = [ctypes.c_int], ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _check(err: int, name: str, kernel: str):
    if err != 0:
        msg = getattr(_lib(name), _ERROR_STRING[name])(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} (cudaError {err})")


def _cuda_tensor(t, what: str, dtype, device, ndim=None, contiguous=True):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor on {device}, "
                        f"got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got shape {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _per_item_scalar(t, what: str, n: int, device) -> int:
    """Checks a device scalar given once or once per item; returns 1 for
    per-item, 0 for one shared value."""
    _cuda_tensor(t, what, torch.float32, device)
    if t.numel() not in (1, n):
        raise ValueError(f"{what} must hold 1 or {n} values, got {t.numel()}")
    return int(t.numel() == n and n > 1)


def _on_cpu(t) -> bool:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
    if t.is_cuda:
        return False
    if not t.is_cpu:
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return True


# --------------------------------------------------------------------------- #
# Fused TV dual ascent
# --------------------------------------------------------------------------- #

#: plain PyTorch version of ``tv_denoise_chw`` (same function and op order)
tv_denoise_chw_plain = tv_denoising_chw

#: the TV kernel's windows, (warps, rows per thread), in csrc/tv_denoise.cu's
#: order: a window is 128 columns by warps x rows per thread rows
TV_WINDOWS = ((8, 4), (8, 12))
#: the backward kernel's windows, likewise (csrc/tv_denoise.cu's VJP_WINDOWS);
#: each keeps a halo of iterations - 1 cells
TV_VJP_WINDOWS = ((16, 2), (16, 4), (16, 6))


def tv_max_iterations() -> int:
    """Largest ``iterations`` the TV kernel takes in one launch (its halo
    of ``iterations`` cells must leave at least one output row in its
    tallest window; csrc/tv_denoise.cu's ``dprox_tv_max_iterations``)."""
    return (max(warps * rows for warps, rows in TV_WINDOWS) - 1) // 2


def tv_window(planes: int, H: int, W: int, iterations: int) -> int:
    """Index into ``TV_WINDOWS`` of the window the kernel picks for this
    call on the current card."""
    return _lib("tv_denoise").dprox_tv_window(planes, H, W, iterations)


def tv_vjp_window(planes: int, H: int, W: int, iterations: int) -> int:
    """Index into ``TV_VJP_WINDOWS`` of the window the backward kernel
    picks for this call on the current card."""
    return _lib("tv_denoise").dprox_tv_vjp_window(planes, H, W, iterations)


def tv_kernel_attributes() -> dict:
    """Registers, local (spill) bytes and static shared bytes of every TV
    kernel as the card's loader reports them (``cudaFuncGetAttributes``),
    by kernel: ``forward 128xR``, ``forward_codes 128xR``, ``backward
    128xR``."""
    lib, out = _lib("tv_denoise"), {}
    for kind, name, windows in ((0, "forward", TV_WINDOWS), (1, "forward_codes", TV_WINDOWS),
                                (2, "backward", TV_VJP_WINDOWS)):
        for i, (warps, rows) in enumerate(windows):
            vals = [ctypes.c_int() for _ in range(3)]
            _check(lib.dprox_tv_kernel_attributes(kind, i, *(ctypes.byref(v) for v in vals)),
                   "tv_denoise", "tv_kernel_attributes")
            out[f"{name} 128x{warps * rows}"] = dict(zip(
                ("registers", "local_bytes", "static_shared_bytes"), (v.value for v in vals)))
    return out


def _requires_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _tv_launch(y0, lam, iterations, window: int = -1, codes: bool = False):
    """One launch of the TV kernel; ``window`` indexes ``TV_WINDOWS``, -1
    lets the kernel pick (``tv_window``). With ``codes`` it returns (the
    output, the clip codes ``tv_denoise_chw_vjp`` reads: [iterations - 1,
    planes, H, W rounded up to 4] uint8, a byte a cell an iteration) from
    the same launch."""
    _cuda_tensor(y0, "y0", torch.float32, y0.device, ndim=3)
    planes, H, W = y0.shape
    per_plane = _per_item_scalar(lam, "lam", planes, y0.device)
    iterations = int(iterations)
    limit = tv_max_iterations()
    if not 1 <= iterations <= limit:
        raise ValueError(f"tv_denoise_chw kernel takes 1..{limit} iterations, got {iterations}")
    if not -1 <= window < len(TV_WINDOWS):
        raise ValueError(f"window must be -1 or an index into TV_WINDOWS, got {window}")
    if window >= 0 and TV_WINDOWS[window][0] * TV_WINDOWS[window][1] <= 2 * iterations:
        raise ValueError(f"window {TV_WINDOWS[window]} leaves no output row at "
                         f"{iterations} iterations")
    out = torch.empty_like(y0)
    code = (torch.empty((iterations - 1, planes, H, -(-W // 4) * 4), dtype=torch.uint8,
                        device=y0.device) if codes else None)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("tv_denoise").dprox_tv_denoise_chw(
            y0.data_ptr(), lam.data_ptr(), per_plane, out.data_ptr(),
            code.data_ptr() if codes and code.numel() else None,
            planes, H, W, iterations, window, stream)
    _check(err, "tv_denoise", "tv_denoise_chw")
    tv_denoise_chw.launches += 1
    return (out, code) if codes else out


def _tv_vjp_launch(codes, lam, iterations, g, window: int = -1):
    """The backward kernel: (d y0, d lam in lam's shape) for the cotangent
    ``g`` of a forward whose launch wrote ``codes`` (``_tv_launch(...,
    codes=True)``), in two launches; ``window`` indexes ``TV_VJP_WINDOWS``,
    -1 lets the kernel pick (``tv_vjp_window``). ``g`` is read through its
    strides (an expanded or strided cotangent costs no copy)."""
    iterations = int(iterations)
    _cuda_tensor(codes, "codes", torch.uint8, codes.device, ndim=4)
    _cuda_tensor(g, "g", torch.float32, codes.device, ndim=3, contiguous=False)
    planes, H, W = g.shape
    if tuple(codes.shape) != (iterations - 1, planes, H, -(-W // 4) * 4):
        raise ValueError(f"codes of shape {tuple(codes.shape)} are not those of {iterations} "
                         f"iterations on g's shape {tuple(g.shape)}")
    per_plane = _per_item_scalar(lam, "lam", planes, codes.device)
    if not -1 <= window < len(TV_VJP_WINDOWS):
        raise ValueError(f"window must be -1 or an index into TV_VJP_WINDOWS, got {window}")
    if window >= 0 and TV_VJP_WINDOWS[window][0] * TV_VJP_WINDOWS[window][1] <= 2 * (
            iterations - 1):
        raise ValueError(f"window {TV_VJP_WINDOWS[window]} leaves no output row at "
                         f"{iterations} iterations")
    lib = _lib("tv_denoise")
    blocks = lib.dprox_tv_vjp_workspace(planes, H, W, iterations, window)
    if blocks < 0:
        raise ValueError(f"tv_denoise_chw_vjp kernel takes 1..{tv_max_iterations()} "
                         f"iterations, got {iterations}")
    work = torch.empty(blocks, dtype=torch.float32, device=codes.device)
    dy = torch.empty((planes, H, W), dtype=torch.float32, device=codes.device)
    dlam = torch.empty(planes if per_plane else 1, dtype=torch.float32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dprox_tv_vjp(codes.data_ptr() if codes.numel() else None, g.data_ptr(),
                               *g.stride(), per_plane, dy.data_ptr(), dlam.data_ptr(),
                               work.data_ptr(), planes, H, W, iterations, window, stream)
    _check(err, "tv_denoise", "tv_denoise_chw_vjp")
    tv_denoise_chw_vjp.launches += 1
    return dy, dlam.reshape(lam.shape)


class _TVFn(torch.autograd.Function):
    """The kernel's forward, which also keeps each dual's clip branch per
    iteration, and the backward kernel (``_tv_vjp_launch``). Not twice
    differentiable: no path of the port takes a double backward."""

    @staticmethod
    def forward(ctx, y0, lam, iterations):
        out, codes = _tv_launch(y0, lam, iterations, codes=True)
        ctx.save_for_backward(codes, lam)
        ctx.iterations = iterations
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():  # create_graph=True
            raise RuntimeError("tv_denoise_chw's backward kernel is not differentiable: "
                               "no double backward (create_graph=True)")
        with vjp_span():
            codes, lam = ctx.saved_tensors
            dy, dlam = _tv_vjp_launch(codes, lam, ctx.iterations, g)
            return (dy if ctx.needs_input_grad[0] else None,
                    dlam if ctx.needs_input_grad[1] else None, None)


def tv_denoise_chw(y0: torch.Tensor, lam, iterations: int = 10) -> torch.Tensor:
    """TV dual ascent on [planes, H, W] float32, every iteration fused.

    ``lam``: float32 device tensor holding one value or one per plane. On
    CPU tensors this is ``models.tv.tv_denoising_chw``. On the card, with
    grad enabled and ``y0`` or ``lam`` requiring it, the output carries the
    gradient of the backward kernel (``_TVFn``, ``tv_denoise_chw_vjp``); the
    forward is one kernel launch either way.
    """
    if _on_cpu(y0):
        return tv_denoise_chw_plain(y0, lam, iterations)
    if _requires_grad(y0, lam):
        return _TVFn.apply(y0, lam, int(iterations))
    return _tv_launch(y0, lam, iterations)


tv_denoise_chw.launches = 0


def _tv_clip_vjp(p, t, c):
    """VJP of ``models.tv._clip`` (``minimum(maximum(p, -t), t)``) at the
    pre-clip value ``p`` for the cotangent ``c``: (p's cotangent, t's), as
    torch.maximum / torch.minimum's backward gives them (the winning side
    takes c, a tie gives each side c / 2, as jnp.maximum does); in
    csrc/tv_denoise.cu's ``clip_vjp`` order."""
    m = torch.maximum(p, -t)
    zero = c.new_zeros(())
    half = c / 2.0
    gm = torch.where(m == t, half, torch.where(m > t, zero, c))
    gt = torch.where(m == t, half, torch.where(m < t, zero, c))
    gm_half = gm / 2.0
    gp = torch.where(p == -t, gm_half, torch.where(p < -t, zero, gm))
    gn = torch.where(p == -t, gm_half, torch.where(p > -t, zero, gm))
    return gp, gt - gn


def tv_denoise_chw_vjp_plain(y0, lam, iterations: int, g):
    """Plain PyTorch version of ``tv_denoise_chw_vjp``: (d y0, d lam) of
    ``tv_denoise_chw_plain(y0, lam, iterations)`` for the output's
    cotangent ``g``, by the explicit adjoint recursion in the kernel's
    operation order (not autograd). With a = g and the pre-clip cotangents
    q = 0, for k = iterations - 1 down to 1: q' = clip_vjp(p_{k-1}, q - D a /
    2) for each dual, a' = D^T(0.2 q'h) + D^T(0.2 q'v), d y0 += a', d t +=
    the clips' shares; d lam = d t / 2, in lam's shape (summed over the
    planes where lam is one value). The clip branches come from the forward
    in y0's dtype and the recursion runs in g's dtype, so a float64 ``g``
    gives a float64 reference on the float32 forward's branches."""
    t = _lam(lam, y0) / 2.0
    zh, zv = torch.zeros_like(y0[..., 1:]), torch.zeros_like(y0[..., 1:, :])
    pre = []  # the pre-clip duals of each live update
    for _ in range(int(iterations) - 1):
        x0 = ((y0 - _dht_w(zh)) + (y0 - _dvt_w(zv))) / 2.0
        ph, pv = zh + 0.2 * _dh_w(x0), zv + 0.2 * _dv_w(x0)
        pre.append((ph, pv))
        zh, zv = _clip(ph, t), _clip(pv, t)
    a = dy = g
    qh, qv = g.new_zeros(zh.shape), g.new_zeros(zv.shape)
    dt = g.new_zeros(y0.shape[:-2])
    for ph, pv in reversed(pre):
        qh, th = _tv_clip_vjp(ph, t, qh - _dh_w(a) / 2.0)
        qv, tv = _tv_clip_vjp(pv, t, qv - _dv_w(a) / 2.0)
        dt = dt + th.sum((-2, -1)) + tv.sum((-2, -1))
        a = _dht_w(0.2 * qh) + _dvt_w(0.2 * qv)
        dy = dy + a
    lam_t = torch.as_tensor(lam)
    dlam = (dt if lam_t.numel() > 1 else dt.sum()) / 2.0
    return dy, dlam.reshape(lam_t.shape)


def tv_denoise_chw_vjp(y0: torch.Tensor, lam, iterations: int, g: torch.Tensor):
    """(d y0, d lam) of ``tv_denoise_chw(y0, lam, iterations)`` for the
    output's cotangent ``g``. On CPU tensors, ``tv_denoise_chw_vjp_plain``;
    on the card the forward kernel with its clip codes, then the backward
    kernel (two launches: every step in one, then the sum of d lam in a
    fixed order, so two calls give the same bits)."""
    if _on_cpu(y0):
        return tv_denoise_chw_vjp_plain(y0, lam, iterations, g)
    _, codes = _tv_launch(y0, lam, iterations, codes=True)
    return _tv_vjp_launch(codes, lam, iterations, g)


tv_denoise_chw_vjp.launches = 0  # backward-kernel calls (each of two launches)


# --------------------------------------------------------------------------- #
# Frequency-diagonal divide
# --------------------------------------------------------------------------- #

def freq_divide_plain(F, diag, rho, eps: float = 1e-7):
    """Plain PyTorch version of ``freq_divide``."""
    return (F + eps) / (diag + rho + eps)


def _sum_to_scalar(g, s: torch.Tensor) -> torch.Tensor:
    """``g`` ([B, ...]) reduced to a scalar operand ``s`` that holds one
    value, or one per batch element, as the kernels read it."""
    if s.numel() > 1:
        return g.sum(dim=tuple(range(1, g.ndim))).reshape(s.shape)
    return g.sum().reshape(s.shape)


def freq_divide_vjp(g, diag, rho, out, eps: float = 1e-7):
    """Gradients of ``(F + eps) / D``, ``D = diag + rho + eps``, with
    respect to F, diag and rho, given the cotangent ``g`` of the output
    ``out``, in PyTorch's convention for complex values: ``g / conj(D)``
    for F and ``-g conj(out) / conj(D)`` for D, whose real part goes to a
    real diag and to rho; each summed to its operand's shape."""
    D = diag + _per_batch(rho, out) + eps
    if not diag.is_complex():
        gD = -(g * out.conj()).real / D
        return g / D, gD.sum_to_size(diag.shape), _sum_to_scalar(gD, rho)
    Dc = D.conj()
    gD = -(g * out.conj()) / Dc
    return g / Dc, gD.sum_to_size(diag.shape), _sum_to_scalar(gD.real, rho)


def _freq_divide_launch(F, diag, rho, eps):
    _cuda_tensor(F, "F", torch.complex64, F.device, ndim=4, contiguous=False)
    complex_diag = diag.dtype == torch.complex64
    _cuda_tensor(diag, "diag", torch.complex64 if complex_diag else torch.float32, F.device,
                 contiguous=False)
    B, C, H, W = F.shape
    per_batch = _per_item_scalar(rho, "rho", B, F.device)
    d = torch.broadcast_to(diag, F.shape)
    out = torch.empty(F.shape, dtype=F.dtype, device=F.device)
    lib = _lib("freq_divide")
    entry = lib.dprox_freq_divide_c64 if complex_diag else lib.dprox_freq_divide
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(F.data_ptr(), *F.stride(), d.data_ptr(), *d.stride(), rho.data_ptr(),
                    per_batch, float(eps), out.data_ptr(), B, C, H, W, stream)
    _check(err, "freq_divide", "freq_divide")
    freq_divide.launches += 1
    freq_divide.complex_launches += complex_diag
    return out


class _FreqDivideFn(torch.autograd.Function):
    """The kernel's forward with the closed-form VJP (``freq_divide_vjp``)."""

    @staticmethod
    def forward(ctx, F, diag, rho, eps):
        out = _freq_divide_launch(F, diag, rho, eps)
        ctx.save_for_backward(diag, rho, out)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        with vjp_span():
            diag, rho, out = ctx.saved_tensors
            return (*freq_divide_vjp(g, diag, rho, out, ctx.eps), None)


def freq_divide(F: torch.Tensor, diag: torch.Tensor, rho: torch.Tensor,
                eps: float = 1e-7) -> torch.Tensor:
    """``(F + eps) / (diag + rho + eps)`` for complex64 F [B, C, H, W].

    F and ``diag`` (float32, or complex64 for a complex divisor;
    broadcastable to F) are read through their strides, so a broadcast,
    sliced or permuted view costs no copy;
    ``rho``: float32 device tensor holding one value or one per batch
    element. The result is contiguous. On the card it is differentiable in
    F, ``diag`` and ``rho`` (``freq_divide_vjp``) where grad is enabled.
    """
    if _on_cpu(F):
        return freq_divide_plain(F, diag, rho, eps)
    if _requires_grad(F, diag, rho):
        return _FreqDivideFn.apply(F, diag, rho, float(eps))
    return _freq_divide_launch(F, diag, rho, eps)


freq_divide.launches = 0
freq_divide.complex_launches = 0  # the complex-divisor entry's share of the launches


# --------------------------------------------------------------------------- #
# Fused ADMM consensus update
# --------------------------------------------------------------------------- #

_ADMM_KINDS = {"nonneg": 0, "soft": 1}


def _real_dtype(t, what: str, kernel: str, dtypes=(torch.float32,)):
    """Raises unless ``t`` has one of the real dtypes ``kernel`` is built
    for. A complex tensor is NotImplementedError: of the kernels, only
    ``freq_divide`` takes complex operands, and no path of the JAX package
    hands the others one (a complex solver state reaches the TV kernel as
    its real part); so is float64 where the kernel is float32 only. Any
    other dtype is a TypeError."""
    if t.dtype in dtypes:
        return
    takes = " or ".join(str(d).replace("torch.", "") for d in dtypes)
    if t.dtype in (torch.complex64, torch.complex128):
        raise NotImplementedError(
            f"{what} is {t.dtype}: the {kernel} CUDA kernel takes no complex tensor "
            f"({takes} only), and no path of the JAX package gives it one")
    if t.dtype == torch.float64:
        raise NotImplementedError(
            f"{what} is float64: the {kernel} CUDA kernel takes {takes} only")
    raise TypeError(f"{what} must be {takes} for the {kernel} kernel, got {t.dtype}")


def _rows(ts, names, kernel: str, dtypes=(torch.float32,)):
    """Checks same-shape, same-dtype contiguous [B, ...] CUDA operands of a
    dtype ``kernel`` takes; returns (B, D)."""
    first = ts[0]
    _real_dtype(first, names[0], kernel, dtypes)
    for t, name in zip(ts, names):
        _cuda_tensor(t, name, first.dtype, first.device)
        if t.shape != first.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(first.shape)}")
    if first.ndim < 1 or first.numel() == 0:
        raise ValueError(f"{names[0]} must be a non-empty [B, ...] tensor, got "
                         f"shape {tuple(first.shape)}")
    return first.shape[0], first.numel() // first.shape[0]


def _per_batch(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """One value, or [B] values as [B, 1, ..., 1] against ``like``."""
    if s.numel() > 1:
        return s.reshape((-1,) + (1,) * (like.ndim - 1))
    return s.reshape(())


def fused_admm_update_plain(Kx, u, lam, kind: str = "nonneg"):
    """Plain PyTorch version of ``fused_admm_update``. ``torch.maximum``
    splits the gradient evenly at a tie (w == 0, |w| == lam), as the JAX
    package's ``jnp.maximum`` does."""
    w = Kx + u
    if kind == "nonneg":
        v = torch.maximum(w, w.new_zeros(()))
    elif kind == "soft":
        lam = _per_batch(torch.as_tensor(lam, dtype=w.dtype, device=w.device), w)
        m = torch.abs(w) - lam
        v = torch.sign(w) * torch.maximum(m, m.new_zeros(()))
    else:
        raise ValueError(f"kind must be 'nonneg' or 'soft', got {kind!r}")
    return v, u + Kx - v


def fused_admm_update_vjp(gv, gu, Kx, u, lam, kind: str = "nonneg"):
    """Gradients of ``fused_admm_update`` with respect to Kx, u and (for
    "soft") lam, given the cotangents ``gv``, ``gu`` of v and u'. With
    ``w = Kx + u`` and ``s = dv/dw``, the cotangent reaching w is
    ``(gv - gu) s`` and Kx and u each get ``gu + (gv - gu) s``; ``s`` is 0.5
    at a tie (w == 0 for nonneg, |w| == lam for soft), as ``jnp.maximum``
    gives. Written in the order autograd takes through the plain version."""
    w = Kx + u
    gvt = gv - gu
    if kind == "nonneg":
        gw = torch.where(w == 0, gvt / 2, gvt).masked_fill_(w < 0, 0.0)
        glam = None
    else:
        m = torch.abs(w) - _per_batch(lam, w)
        sg = torch.sign(w)
        gm = gvt * sg
        gm = torch.where(m == 0, gm / 2, gm).masked_fill_(m < 0, 0.0)
        gw = gm * sg
        glam = -_sum_to_scalar(gm, lam)
    g = gu + gw
    return g, g, glam


def _admm_launch(Kx, u, lam, kind):
    B, D = _rows((Kx, u), ("Kx", "u"), "fused_admm_update")
    if kind == "soft":
        per_batch, lam_ptr = _per_item_scalar(lam, "lam", B, Kx.device), lam.data_ptr()
    else:
        per_batch, lam_ptr = 0, None
    v, u_new = torch.empty_like(Kx), torch.empty_like(Kx)
    with torch.cuda.device(Kx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("fused_admm_update").dprox_fused_admm_update(
            Kx.data_ptr(), u.data_ptr(), lam_ptr, per_batch, _ADMM_KINDS[kind],
            v.data_ptr(), u_new.data_ptr(), B * D, D, stream)
    _check(err, "fused_admm_update", "fused_admm_update")
    fused_admm_update.launches += 1
    return v, u_new


class _AdmmUpdateFn(torch.autograd.Function):
    """The kernel's forward with the closed-form VJP
    (``fused_admm_update_vjp``)."""

    @staticmethod
    def forward(ctx, Kx, u, lam, kind):
        v, u_new = _admm_launch(Kx, u, lam, kind)
        ctx.kind = kind
        ctx.save_for_backward(Kx, u, lam)
        return v, u_new

    @staticmethod
    def backward(ctx, gv, gu):
        with vjp_span():
            return (*fused_admm_update_vjp(gv, gu, *ctx.saved_tensors, ctx.kind), None)


def fused_admm_update(Kx: torch.Tensor, u: torch.Tensor, lam,
                      kind: str = "nonneg"):
    """``v = prox(Kx + u)``, ``u' = u + Kx - v`` in one pass; returns
    ``(v, u')`` as new tensors, equal to the unfused form exactly.

    ``kind``: "nonneg" (``max(w, 0)``; ``lam`` is neither checked nor
    read, as the plain version ignores it) or "soft"
    (``sign(w) * max(|w| - lam, 0)``). Kx, u: contiguous float32 of one
    shape, batch leading; ``lam``: float32 tensor on their device holding
    one value or one per batch element. On the card, where grad is
    enabled, v and u' are differentiable in Kx, u and (soft) lam
    (``fused_admm_update_vjp``).
    """
    if kind not in _ADMM_KINDS:
        raise ValueError(f"kind must be 'nonneg' or 'soft', got {kind!r}")
    if _on_cpu(Kx):
        return fused_admm_update_plain(Kx, u, lam, kind)
    lam = lam if kind == "soft" else None
    if _requires_grad(Kx, u, lam):
        return _AdmmUpdateFn.apply(Kx, u, lam, kind)
    return _admm_launch(Kx, u, lam, kind)


fused_admm_update.launches = 0


# --------------------------------------------------------------------------- #
# Batched dot product and the fused CG tail
# --------------------------------------------------------------------------- #

def bdot_plain(p, q):
    """Plain PyTorch version of ``bdot``."""
    B = p.shape[0]
    return torch.sum(p.reshape(B, -1) * q.reshape(B, -1), dim=1)


def bdot_workspace(p: torch.Tensor) -> Optional[torch.Tensor]:
    """The workspace ``bdot`` needs for rows like ``p``'s ([B, ...] on the
    card), or None where a row is short enough for one block: made once by a
    loop that calls ``bdot(..., out=, workspace=)`` every iteration."""
    if _on_cpu(p):
        return None
    B = p.shape[0]
    n = _lib("bdot").dprox_bdot_workspace(B, p.numel() // B, p.element_size())
    if n < 0:
        raise ValueError(f"bdot takes no {B} rows of {p.numel() // B} elements")
    return torch.empty(n, dtype=p.dtype, device=p.device) if n > 0 else None


def _bdot_launch(p: torch.Tensor, q: torch.Tensor, out=None, work=None) -> torch.Tensor:
    B, D = _rows((p, q), ("p", "q"), "bdot", (torch.float32, torch.float64))
    lib = _lib("bdot")
    entry = lib.dprox_bdot if p.dtype == torch.float32 else lib.dprox_bdot_f64
    if out is None:
        out = torch.empty(B, dtype=p.dtype, device=p.device)
    else:
        _cuda_tensor(out, "out", p.dtype, p.device)
        if out.numel() != B:
            raise ValueError(f"out must hold {B} values, got {out.numel()}")
    n_work = lib.dprox_bdot_workspace(B, D, p.element_size())
    if work is None:
        work = torch.empty(n_work, dtype=p.dtype, device=p.device) if n_work > 0 else None
    elif work.dtype != p.dtype or work.device != p.device or work.numel() < n_work:
        raise ValueError(f"the workspace must hold {n_work} {p.dtype} values on {p.device}")
    err = entry(p.data_ptr(), q.data_ptr(), out.data_ptr(),
                work.data_ptr() if n_work > 0 else None, B, D, p.device.index,
                torch.cuda.current_stream(p.device).cuda_stream)
    _check(err, "bdot", "bdot")
    bdot.launches += 1
    return out


class _BdotFn(torch.autograd.Function):
    """The kernel's forward with the gradient of a dot product:
    d<p, q>/dp = q, d<p, q>/dq = p, each scaled by its row's cotangent."""

    @staticmethod
    def forward(ctx, p, q):
        ctx.save_for_backward(p, q)
        return _bdot_launch(p, q)

    @staticmethod
    def backward(ctx, g):
        with vjp_span():
            p, q = ctx.saved_tensors
            g = g.reshape((-1,) + (1,) * (p.ndim - 1))
            return (g * q if ctx.needs_input_grad[0] else None,
                    g * p if ctx.needs_input_grad[1] else None)


def bdot(p: torch.Tensor, q: torch.Tensor, out: Optional[torch.Tensor] = None,
         workspace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-batch dot products ``<p_b, q_b>`` over every dim but the first;
    returns [B].

    On the card: contiguous float32 or float64 operands, accumulation in
    their type, and a fixed summation order (no atomics), so two calls
    give the same bits. Differentiable in both operands on either device.
    ``out`` ([B]) and ``workspace`` (``bdot_workspace``), where given, are
    written instead of new tensors, on the card and without grad only; the
    plain version returns a new tensor.
    """
    if _on_cpu(p):
        return bdot_plain(p, q)
    if _requires_grad(p, q):
        if out is not None or workspace is not None:
            raise ValueError("bdot under grad takes no out or workspace")
        return _BdotFn.apply(p, q)
    return _bdot_launch(p, q, out, workspace)


bdot.launches = 0


def fused_cg_tail_plain(x, r, p, Ap, rs):
    """Plain PyTorch version of ``fused_cg_tail``."""
    exp = lambda s: s.reshape((-1,) + (1,) * (x.ndim - 1))
    pAp = bdot_plain(p, Ap)
    alpha = rs / torch.clamp(pAp, min=1e-32)
    x = x + exp(alpha) * p
    r = r - exp(alpha) * Ap
    rs_new = bdot_plain(r, r)
    beta = rs_new / torch.clamp(rs, min=1e-32)
    p = r + exp(beta) * p
    return x, r, p, rs_new


def fused_cg_tail_vjp(gx, gr, gp, grs, p, Ap, rs, r_new, rs_new):
    """Gradients of ``fused_cg_tail`` with respect to (x, r, p, Ap, rs),
    given the cotangents of (x', r', p', rs') and the call's p, Ap, rs, r'
    and rs'. With ``a = rs / max(<p, Ap>, 1e-32)`` and ``b = rs' /
    max(rs, 1e-32)``, written out from x' = x + a p, r' = r - a Ap,
    rs' = <r', r'>, p' = r' + b p; each floor passes the gradient where its
    operand is at or above it, as the plain version's ``torch.clamp`` does."""
    e = lambda s: s.reshape((-1,) + (1,) * (p.ndim - 1))
    pAp = bdot_plain(p, Ap)
    cp, cr = torch.clamp(pAp, min=1e-32), torch.clamp(rs, min=1e-32)
    alpha, beta = rs / cp, rs_new / cr
    gbeta = bdot_plain(gp, p)
    g_rnew = gr + gp + 2 * e(grs + gbeta / cr) * r_new
    galpha = bdot_plain(gx, p) - bdot_plain(g_rnew, Ap)
    gpAp = -galpha * rs / (cp * cp) * (pAp >= 1e-32)
    g_rs = galpha / cp - gbeta * rs_new / (cr * cr) * (rs >= 1e-32)
    g_p = e(alpha) * gx + e(beta) * gp + e(gpAp) * Ap
    g_Ap = -e(alpha) * g_rnew + e(gpAp) * p
    return gx, g_rnew, g_p, g_Ap, g_rs


def _cg_tail_launch(x, r, p, Ap, rs):
    B, D = _rows((x, r, p, Ap), ("x", "r", "p", "Ap"), "fused_cg_tail")
    _real_dtype(rs, "rs", "fused_cg_tail")
    _cuda_tensor(rs, "rs", torch.float32, x.device, ndim=1)
    if rs.numel() != B:
        raise ValueError(f"rs must hold {B} values, got {rs.numel()}")
    lib = _lib("cg_tail")
    x_out, r_out, p_out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    rs_out = torch.empty_like(rs)
    n_work = lib.dprox_cg_tail_workspace(B, D)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device) if n_work > 0 else None
    err = lib.dprox_cg_tail(
        x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(), rs.data_ptr(),
        x_out.data_ptr(), r_out.data_ptr(), p_out.data_ptr(), rs_out.data_ptr(),
        work.data_ptr() if n_work > 0 else None, B, D, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "cg_tail", "fused_cg_tail")
    fused_cg_tail.launches += 1
    return x_out, r_out, p_out, rs_out


class _CgTailFn(torch.autograd.Function):
    """The kernel's forward with the closed-form VJP (``fused_cg_tail_vjp``)."""

    @staticmethod
    def forward(ctx, x, r, p, Ap, rs):
        outs = _cg_tail_launch(x, r, p, Ap, rs)
        ctx.save_for_backward(p, Ap, rs, outs[1], outs[3])
        return outs

    @staticmethod
    def backward(ctx, gx, gr, gp, grs):
        with vjp_span():
            return fused_cg_tail_vjp(gx, gr, gp, grs, *ctx.saved_tensors)


def fused_cg_tail(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                  Ap: torch.Tensor, rs: torch.Tensor):
    """One CG iteration minus the matvec, per batch element:
    ``alpha = rs / max(<p, Ap>, 1e-32)``, ``x' = x + alpha p``,
    ``r' = r - alpha Ap``, ``rs' = <r', r'>``, ``beta = rs' / max(rs, 1e-32)``,
    ``p' = r' + beta p``; returns ``(x', r', p', rs')`` as new tensors.

    x, r, p, Ap: contiguous float32 [B, ...] of one shape; rs: float32 [B].
    The scalars stay on the device and the sums have a fixed order. The
    outputs are new tensors: ``cg_pallas`` starts with p aliasing r, so an
    update in place would be wrong. On the card, where grad is enabled,
    the outputs are differentiable in all five inputs (``fused_cg_tail_vjp``).
    """
    if _on_cpu(x):
        return fused_cg_tail_plain(x, r, p, Ap, rs)
    if _requires_grad(x, r, p, Ap, rs):
        return _CgTailFn.apply(x, r, p, Ap, rs)
    return _cg_tail_launch(x, r, p, Ap, rs)


fused_cg_tail.launches = 0

# --------------------------------------------------------------------------- #
# Preconditioned CG on mosaic(conv(x)): the stages between the FFTs
# --------------------------------------------------------------------------- #
#
# One wrapper a stage of linalg/structured.py::mosaic_conv_pcg (csrc/
# mosaic_pcg.cu). Fields are [B, C, H, W]: float32, or complex64 where an
# FFT reads or wrote them; the inverse FFTs before ``mcg_mask``, ``mcg_gram``,
# ``mcg_real`` and ``mcg_residual`` are unscaled and ``scale`` is 1 / (H W).
# On the card a wrapper writes the buffers it is given (in place where a
# stage updates a field) and returns them; a plain version returns new
# tensors with the same values, in the order of least_squares.solve_cg's
# matvec and of ``linalg.solvers.pcg``. No autograd: the solve runs under
# the implicit-gradient wrapper.

def bayer_parity_mask(C: int, H: int, W: int, device=None) -> torch.Tensor:
    """The RGGB mask as [1, C, H, W] float32 from (c, h, w) parity, as
    csrc/mosaic_pcg.cu computes it: R where h and w are even, G where their
    parities differ, B where both are odd (utils/imaging.py::bayer_mask for
    C = 3)."""
    h = torch.arange(H, device=device).reshape(H, 1) % 2
    w = torch.arange(W, device=device).reshape(1, W) % 2
    planes = [(h == 0) & (w == 0), h != w, (h == 1) & (w == 1)]
    return torch.stack([planes[c % 3] for c in range(C)])[None].to(torch.float32)


def _mcg_fields(ts, names, shape, device):
    """Checks contiguous CUDA fields of ``shape`` (float32 or complex64);
    returns (B, C, H * W)."""
    for t, name in zip(ts, names):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {device}")
        if t.dtype not in (torch.float32, torch.complex64) or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be float32 or complex64 of shape {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    B, C, H, W = shape
    return B, C, H * W


def _mcg_slots(ts, names, n: int, device, dtype=torch.float32):
    """Checks the per-batch scalars a stage reads or writes: contiguous
    ``dtype`` tensors of ``n`` values on ``device``."""
    for t, name in zip(ts, names):
        _cuda_tensor(t, name, dtype, device)
        if t.numel() != n:
            raise ValueError(f"{name} must hold {n} values, got {t.numel()}")


def _mcg_call(entry: str, kernel, device, *args):
    err = getattr(_lib("mosaic_pcg"), entry)(*args, device.index,
                                             torch.cuda.current_stream(device).cuda_stream)
    _check(err, "mosaic_pcg", kernel.__name__)
    kernel.launches += 1


def mcg_otf_apply_plain(F, otf, adjoint: bool):
    """Plain PyTorch version of ``mcg_otf_apply``."""
    return (torch.conj(otf) if adjoint else otf) * F


def mcg_otf_apply(F: torch.Tensor, otf: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """``otf * F`` (``conj(otf) * F`` with ``adjoint``), F in place; ``otf``
    [1, C, H, W] complex64, contiguous."""
    if _on_cpu(F):
        return mcg_otf_apply_plain(F, otf, adjoint)
    B, C, hw = _mcg_fields((F,), ("F",), F.shape, F.device)
    _mcg_fields((otf,), ("otf",), (1,) + tuple(F.shape[1:]), F.device)
    _mcg_call("dprox_mcg_otf_apply", mcg_otf_apply, F.device, F.data_ptr(), otf.data_ptr(),
              int(adjoint), B, C, hw)
    return F


def mcg_mask_plain(G, scale: float):
    """Plain PyTorch version of ``mcg_mask``."""
    m = bayer_parity_mask(*G.shape[1:], device=G.device)
    return (m * (m * (G.real * scale))).to(torch.complex64)


def mcg_mask(G: torch.Tensor, scale: float) -> torch.Tensor:
    """``complex(m * (m * (scale * Re G)), 0)``, the Bayer mask's forward and
    adjoint (``bayer_parity_mask``), G in place."""
    if _on_cpu(G):
        return mcg_mask_plain(G, scale)
    B, C, H, W = G.shape
    _mcg_fields((G,), ("G",), G.shape, G.device)
    _mcg_call("dprox_mcg_mask", mcg_mask, G.device, G.data_ptr(), float(scale), B, C, H, W)
    return G


def mcg_gram_plain(Kc, p, rho, n_rho: int, scale: float):
    """Plain PyTorch version of ``mcg_gram``."""
    out = 0.0 + Kc.real * scale
    for _ in range(n_rho):
        out = out + rho * p
    return out


def mcg_gram(Kc: torch.Tensor, p: torch.Tensor, rho: torch.Tensor, n_rho: int, scale: float,
             Ap: torch.Tensor, rmax: torch.Tensor) -> torch.Tensor:
    """``A p = (0 + scale * Re Kc) + rho * p``, the last term ``n_rho`` times,
    into ``Ap``; on the card it also zeroes ``rmax`` ([B]) for ``mcg_step``."""
    if _on_cpu(p):
        return mcg_gram_plain(Kc, p, rho, n_rho, scale)
    B, C, hw = _mcg_fields((Kc, p, Ap), ("Kc", "p", "Ap"), p.shape, p.device)
    _mcg_slots((rmax,), ("rmax",), B, p.device)
    _mcg_call("dprox_mcg_gram", mcg_gram, p.device, Kc.data_ptr(), p.data_ptr(),
              rho.data_ptr(), _per_item_scalar(rho, "rho", B, p.device), int(n_rho), float(scale),
              Ap.data_ptr(), rmax.data_ptr(), B, C, hw)
    return Ap


def _bmax_plain(t):
    return t.reshape(t.shape[0], -1).abs().amax(dim=1)


def mcg_step_plain(x, r, p, Ap, rz, pAp):
    """Plain PyTorch version of ``mcg_step``."""
    alpha = _per_batch(rz / torch.clamp(pAp, min=1e-32), x)
    x = x + alpha * p
    r = r - alpha * Ap
    return x, r, r.to(torch.complex64), _bmax_plain(r)


def mcg_step(x, r, p, Ap, rz, pAp, r_c, rmax):
    """``alpha = rz / max(pAp, 1e-32)``, ``x += alpha p``, ``r -= alpha Ap``
    (x and r in place), ``r_c = complex(r)`` and ``rmax`` = max |r| per batch
    element; returns (x, r, r_c, rmax)."""
    if _on_cpu(x):
        return mcg_step_plain(x, r, p, Ap, rz, pAp)
    B, C, hw = _mcg_fields((x, r, p, Ap, r_c), ("x", "r", "p", "Ap", "r_c"), x.shape,
                           x.device)
    _mcg_slots((rz, pAp, rmax), ("rz", "pAp", "rmax"), B, x.device)
    _mcg_call("dprox_mcg_step", mcg_step, x.device, x.data_ptr(), r.data_ptr(), p.data_ptr(),
              Ap.data_ptr(), rz.data_ptr(), pAp.data_ptr(), r_c.data_ptr(), rmax.data_ptr(),
              B, C, hw)
    return x, r, r_c, rmax


def mcg_precond_plain(R, mdiag):
    """Plain PyTorch version of ``mcg_precond``."""
    return R / mdiag


def mcg_precond(R: torch.Tensor, mdiag: torch.Tensor) -> torch.Tensor:
    """``R / mdiag``, the frequency-Jacobi preconditioner, R in place;
    ``mdiag`` float32 [1 or B, C, H, W], contiguous."""
    if _on_cpu(R):
        return mcg_precond_plain(R, mdiag)
    B, C, hw = _mcg_fields((R,), ("R",), R.shape, R.device)
    _mcg_fields((mdiag,), ("mdiag",), (mdiag.shape[0],) + tuple(R.shape[1:]), R.device)
    if mdiag.shape[0] not in (1, B):
        raise ValueError(f"mdiag must hold 1 or {B} batch elements, got {mdiag.shape[0]}")
    _mcg_call("dprox_mcg_precond", mcg_precond, R.device, R.data_ptr(), mdiag.data_ptr(),
              int(mdiag.shape[0] == B and B > 1), B, C, hw)
    return R


def mcg_real_plain(Zc, scale: float):
    """Plain PyTorch version of ``mcg_real``."""
    return Zc.real * scale


def mcg_real(Zc: torch.Tensor, scale: float, z: torch.Tensor) -> torch.Tensor:
    """``z = scale * Re Zc``."""
    if _on_cpu(Zc):
        return mcg_real_plain(Zc, scale)
    B, C, hw = _mcg_fields((Zc, z), ("Zc", "z"), z.shape, z.device)
    _mcg_call("dprox_mcg_real", mcg_real, z.device, Zc.data_ptr(), float(scale), z.data_ptr(),
              B, C, hw)
    return z


def mcg_direction_plain(z, p, rz_new, rz, rmax, bmax, rtol: float, first: bool):
    """Plain PyTorch version of ``mcg_direction``."""
    if not first:
        p = z + _per_batch(rz_new / torch.clamp(rz, min=1e-32), p) * p
    else:
        p = z
    flag = (rmax > rtol * torch.clamp(bmax, min=1e-32)).any()
    return p, p.to(torch.complex64), flag


def mcg_direction(z, p, rz_new, rz, p_c, rmax, bmax, rtol: float, flag, first: bool = False):
    """``beta = rz_new / max(rz, 1e-32)``, ``p = z + beta p`` (with ``first``:
    ``p = z``; p in place), ``p_c = complex(p)``, and the stop test ``flag =
    any(rmax > rtol * max(bmax, 1e-32))`` (an int32 [1] on the card); returns
    (p, p_c, flag)."""
    if _on_cpu(z):
        return mcg_direction_plain(z, p, rz_new, rz, rmax, bmax, rtol, first)
    B, C, hw = _mcg_fields((z, p, p_c), ("z", "p", "p_c"), z.shape, z.device)
    _mcg_slots((rz_new, rz, rmax, bmax), ("rz_new", "rz", "rmax", "bmax"), B, z.device)
    _mcg_slots((flag,), ("flag",), 1, z.device, torch.int32)
    _mcg_call("dprox_mcg_direction", mcg_direction, z.device, z.data_ptr(), p.data_ptr(),
              rz_new.data_ptr(), rz.data_ptr(), p_c.data_ptr(), rmax.data_ptr(),
              bmax.data_ptr(), float(rtol), flag.data_ptr(), int(first), B, C, hw)
    return p, p_c, flag


def mcg_start_plain(x0, b):
    """Plain PyTorch version of ``mcg_start``."""
    x = torch.zeros_like(b) if x0 is None else x0
    return x, x.to(torch.complex64)


def mcg_start(x0, b, x, x_c, rmax, bmax):
    """``x = x0`` (zeros where x0 is None), ``x_c = complex(x)``; on the card
    it also zeroes ``rmax`` and ``bmax`` ([B]) for ``mcg_residual``; returns
    (x, x_c)."""
    if _on_cpu(b):
        return mcg_start_plain(x0, b)
    B, C, hw = _mcg_fields((x0, x, x_c), ("x0", "x", "x_c"), b.shape, b.device)
    _mcg_slots((rmax, bmax), ("rmax", "bmax"), B, b.device)
    _mcg_call("dprox_mcg_start", mcg_start, b.device,
              None if x0 is None else x0.data_ptr(), x.data_ptr(), x_c.data_ptr(),
              rmax.data_ptr(), bmax.data_ptr(), B, C, hw)
    return x, x_c


def mcg_residual_plain(Kc, b, x, rho, n_rho: int, scale: float):
    """Plain PyTorch version of ``mcg_residual``."""
    r = b - mcg_gram_plain(Kc, x, rho, n_rho, scale)
    return r, r.to(torch.complex64), _bmax_plain(r), _bmax_plain(b)


def mcg_residual(Kc, b, x, rho, n_rho: int, scale: float, r, r_c, rmax, bmax):
    """``r = b - A x`` with ``A x`` as ``mcg_gram`` forms it from Kc, ``r_c =
    complex(r)``, ``rmax`` = max |r| and ``bmax`` = max |b| per batch element;
    returns (r, r_c, rmax, bmax)."""
    if _on_cpu(b):
        return mcg_residual_plain(Kc, b, x, rho, n_rho, scale)
    B, C, hw = _mcg_fields((Kc, b, x, r, r_c), ("Kc", "b", "x", "r", "r_c"), b.shape,
                           b.device)
    _mcg_slots((rmax, bmax), ("rmax", "bmax"), B, b.device)
    _mcg_call("dprox_mcg_residual", mcg_residual, b.device, Kc.data_ptr(), b.data_ptr(),
              x.data_ptr(), rho.data_ptr(), _per_item_scalar(rho, "rho", B, b.device), int(n_rho),
              float(scale), r.data_ptr(), r_c.data_ptr(), rmax.data_ptr(), bmax.data_ptr(),
              B, C, hw)
    return r, r_c, rmax, bmax


MCG_KERNELS = (mcg_start, mcg_residual, mcg_otf_apply, mcg_mask, mcg_gram, mcg_step,
               mcg_precond, mcg_real, mcg_direction)
for _fn in MCG_KERNELS:
    _fn.launches = 0

# --------------------------------------------------------------------------- #
# Sparse matrix-vector products: compressed rows and dense tiles
# --------------------------------------------------------------------------- #

CSR_SHORT_ROW = 16  # rows of at most this many non-zeros: a thread each (csr_matvec.cu MAX_SHORT)
CSR_WARP_ROW = 128  # rows of at most this many: a warp each (WARP_ROW)
CSR_CHUNK = 4096    # longer rows: pieces of at most this many, a thread block each (MAX_CHUNK)


class Split(NamedTuple):
    """``csr_matvec``'s cut of a matrix's rows, by non-zeros and not by
    rows. A row of at most ``CSR_SHORT_ROW`` non-zeros is summed by one
    thread and one of at most ``CSR_WARP_ROW`` by one warp; every longer
    row is cut into pieces of at most ``CSR_CHUNK``, one thread block's
    work each. Piece p is the non-zeros ``begin[p]:end[p]`` of row
    ``owner[p]``; the ``n_wide`` block pieces come before the warp rows'
    (a warp row is one piece). The pieces of the ``n_split`` rows cut in
    two or more come first of all (``split_ptr`` delimits each one's) and
    write partial sums, which a second launch adds in order; the others
    write their row's output. ``item_seg`` and ``seg_owner`` give the
    plain version the same cut: the piece of each non-zero (its row where
    the row is uncut) and, when some row is cut, the row of each piece."""
    n_rows: int
    owner: torch.Tensor
    begin: torch.Tensor
    end: torch.Tensor
    split_ptr: torch.Tensor
    n_wide: int
    n_split: int
    n_split_pieces: int
    item_seg: torch.Tensor
    seg_owner: Optional[torch.Tensor]


def csr_split(indptr, device=None) -> Split:
    """The ``Split`` of the rows that ``indptr`` ([m + 1] offsets)
    delimits, built on the host (one read of a device ``indptr``); the
    arrays go to ``device``."""
    ptr = np.asarray(indptr.cpu() if isinstance(indptr, torch.Tensor) else indptr, np.int64)
    if ptr.ndim != 1 or ptr.size < 1 or ptr[0] != 0 or (np.diff(ptr) < 0).any():
        raise ValueError("row offsets must be non-decreasing from 0")
    lengths = np.diff(ptr)
    m = lengths.size
    pieces_of = lambda n: np.maximum(1, -(-n // CSR_CHUNK))
    wide = np.flatnonzero(lengths > CSR_WARP_ROW)
    counts = pieces_of(lengths[wide])
    cut = counts > 1
    warp_rows = np.flatnonzero((lengths > CSR_SHORT_ROW) & (lengths <= CSR_WARP_ROW))
    # cut rows' pieces first, then whole rows by blocks, then by warps
    rows = np.concatenate([wide[cut], wide[~cut], warp_rows])
    counts = np.concatenate([counts[cut], counts[~cut], np.ones(warp_rows.size, np.int64)])
    owner = np.repeat(rows, counts)
    k = np.arange(owner.size) - np.repeat(np.cumsum(counts) - counts, counts)
    begin = ptr[owner] + k * CSR_CHUNK
    end = np.minimum(begin + CSR_CHUNK, ptr[owner + 1])
    n_split = int(cut.sum())
    split_ptr = np.concatenate([[0], np.cumsum(counts[:n_split])])
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    row_of_item = np.repeat(np.arange(m), lengths)
    row_pieces = pieces_of(lengths)
    item_seg, seg_owner = put(row_of_item), None
    if (row_pieces > 1).any():
        first = np.cumsum(row_pieces) - row_pieces
        item_seg = put(first[row_of_item] + (np.arange(ptr[-1]) - ptr[row_of_item]) // CSR_CHUNK)
        seg_owner = put(np.repeat(np.arange(m), row_pieces))
    return Split(m, put(owner), put(begin), put(end), put(split_ptr),
                 owner.size - warp_rows.size, n_split, int(split_ptr[-1]), item_seg, seg_owner)


def bsr_matvec_plain(tiles, idx_in, idx_out, x_blocks, n_out_blocks: int):
    """Plain PyTorch version of ``bsr_matvec``: per-tile products, then a
    sum into each tile's output block."""
    prod = torch.einsum("tij,tj->ti", tiles, x_blocks[idx_in.long()])
    out = torch.zeros((n_out_blocks, tiles.shape[1]), dtype=tiles.dtype,
                      device=tiles.device)
    return out.index_add_(0, idx_out.long(), prod)


def bsr_row_ptr(idx_out: torch.Tensor, n_out_blocks: int) -> torch.Tensor:
    """[n_out_blocks + 1] int32 offsets of each output block's tiles in the
    sorted ``idx_out``; computed on ``idx_out``'s device without a host read."""
    edges = torch.arange(n_out_blocks + 1, dtype=idx_out.dtype, device=idx_out.device)
    return torch.searchsorted(idx_out.contiguous(), edges).to(torch.int32)


def bsr_matvec(tiles: torch.Tensor, idx_in: torch.Tensor, idx_out: torch.Tensor,
               x_blocks: torch.Tensor, n_out_blocks: int,
               row_ptr: torch.Tensor | None = None) -> torch.Tensor:
    """``y[idx_out[t]] += tiles[t] @ x_blocks[idx_in[t]]`` over (T, bm, bn)
    tiles; ``x_blocks`` is (Nb, bn); returns (n_out_blocks, bm), zero where
    no tile lands.

    ``idx_out`` must be sorted (tiles ordered by output block), and every
    ``idx_in`` must name a row of ``x_blocks``. ``row_ptr`` is
    ``bsr_row_ptr(idx_out, n_out_blocks)``; an operator that is applied
    many times computes it once and passes it, and then vouches for its
    indices: without ``row_ptr`` the wrapper checks them on the card (one
    host read). On the card: contiguous
    float32 or float64 tiles and ``x_blocks`` of one dtype, int32 indices;
    products and sums in that dtype, each output written once in a fixed
    order, so two calls give the same bits. ``T == 0`` returns zeros
    without a launch. Not differentiable by itself: ``algo.lp.utils.BSRMat``
    wraps it with its transposed apply as the backward.
    """
    T, bm, bn = tiles.shape
    n_out_blocks = int(n_out_blocks)
    if _on_cpu(tiles):
        return bsr_matvec_plain(tiles, idx_in, idx_out, x_blocks, n_out_blocks)
    dev = tiles.device
    _real_dtype(tiles, "tiles", "bsr_matvec", (torch.float32, torch.float64))
    _cuda_tensor(tiles, "tiles", tiles.dtype, dev, ndim=3)
    _cuda_tensor(x_blocks, "x_blocks", tiles.dtype, dev, ndim=2)
    _cuda_tensor(idx_in, "idx_in", torch.int32, dev, ndim=1)
    if x_blocks.shape[1] != bn or idx_in.numel() != T or n_out_blocks < 1 or bm < 1:
        raise ValueError(f"tiles {tuple(tiles.shape)}, x_blocks {tuple(x_blocks.shape)}, "
                         f"{idx_in.numel()} input indices and {n_out_blocks} output "
                         "blocks do not fit together")
    if T == 0:
        return torch.zeros((n_out_blocks, bm), dtype=tiles.dtype, device=dev)
    if row_ptr is None:
        _cuda_tensor(idx_out, "idx_out", torch.int32, dev, ndim=1)
        if idx_out.numel() != T:
            raise ValueError(f"idx_out must hold {T} values, got {idx_out.numel()}")
        in_range = ((idx_out[1:] >= idx_out[:-1]).all() & (idx_out[0] >= 0)
                    & (idx_out[-1] < n_out_blocks) & (idx_in >= 0).all()
                    & (idx_in < x_blocks.shape[0]).all())
        if not bool(in_range):
            raise ValueError("idx_out must be sorted and within the output blocks, and "
                             "idx_in within the rows of x_blocks")
        row_ptr = bsr_row_ptr(idx_out, n_out_blocks)
    _cuda_tensor(row_ptr, "row_ptr", torch.int32, dev, ndim=1)
    if row_ptr.numel() != n_out_blocks + 1:
        raise ValueError(f"row_ptr must hold {n_out_blocks + 1} values, got {row_ptr.numel()}")
    out = torch.empty((n_out_blocks, bm), dtype=tiles.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("bsr_matvec").dprox_bsr_matvec(
            tiles.data_ptr(), idx_in.data_ptr(), row_ptr.data_ptr(), x_blocks.data_ptr(),
            out.data_ptr(), n_out_blocks, bm, bn, int(tiles.dtype == torch.float64), stream)
    _check(err, "bsr_matvec", "bsr_matvec")
    bsr_matvec.launches += 1
    return out


bsr_matvec.launches = 0


def csr_matvec_plain(indptr, indices, values, x, split: Split):
    """Plain PyTorch version of ``csr_matvec``: gather, multiply, and a
    segment sum in the operands' dtype (in row order on the CPU), over the
    pieces of ``split`` where a row is cut (each piece's products, then the
    row's pieces). ``split`` is ``csr_split(indptr)``."""
    prod = values * x.index_select(0, indices)
    m = indptr.numel() - 1
    zeros = lambda n: torch.zeros(n, dtype=prod.dtype, device=prod.device)
    if split.seg_owner is None:
        return zeros(m).index_add_(0, split.item_seg, prod)
    pieces = zeros(split.seg_owner.numel()).index_add_(0, split.item_seg, prod)
    return zeros(m).index_add_(0, split.seg_owner, pieces)


def csr_matvec(indptr: torch.Tensor, indices: torch.Tensor, values: torch.Tensor,
               x: torch.Tensor, split: Split | None = None) -> torch.Tensor:
    """``y = A x`` for A in compressed-row form: ``indptr`` [m + 1] int32
    row offsets, ``indices`` [nnz] int32 columns, ``values`` [nnz]; ``x``
    is the flat [n] vector, without padding; returns [m].

    ``split`` is ``csr_split(indptr)``; an operator that is applied many
    times builds it once and passes it, and then vouches for its indices:
    without ``split`` the wrapper builds it and, on the card, checks the
    indices (host reads). On the card: contiguous float32 or float64
    ``values`` and ``x`` of one dtype; products and sums in that dtype,
    each output written once in an order fixed by the matrix (a row of
    more than ``CSR_CHUNK`` non-zeros in pieces whose partial sums a
    second launch adds), so two calls give the same bits. ``nnz == 0``
    returns zeros without a launch. Not differentiable by itself:
    ``algo.lp.utils.BSRMat`` wraps it with its transposed apply as the
    backward.
    """
    m = indptr.numel() - 1
    if split is None:
        split = csr_split(indptr, indptr.device)
        if not _on_cpu(values) and values.numel() and not bool(
                (indices >= 0).all() & (indices < x.numel()).all()):
            raise ValueError("indices must lie within x")
    if _on_cpu(values):
        return csr_matvec_plain(indptr, indices, values, x, split)
    dev = values.device
    _real_dtype(values, "values", "csr_matvec", (torch.float32, torch.float64))
    _cuda_tensor(values, "values", values.dtype, dev, ndim=1)
    _cuda_tensor(x, "x", values.dtype, dev, ndim=1)
    _cuda_tensor(indptr, "indptr", torch.int32, dev, ndim=1)
    _cuda_tensor(indices, "indices", torch.int32, dev, ndim=1)
    if m < 1 or indices.numel() != values.numel():
        raise ValueError(f"indptr of {indptr.numel()} offsets, {indices.numel()} indices and "
                         f"{values.numel()} values do not fit together")
    if not isinstance(split, Split) or split.n_rows != m or split.owner.device != dev:
        raise ValueError(f"the split must be csr_split(indptr, {dev}) of {m} rows")
    if values.numel() == 0:
        return torch.zeros(m, dtype=values.dtype, device=dev)
    y = torch.empty(m, dtype=values.dtype, device=dev)
    partial = (torch.empty(split.n_split_pieces, dtype=values.dtype, device=dev)
               if split.n_split_pieces else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("csr_matvec").dprox_csr_matvec(
            indptr.data_ptr(), indices.data_ptr(), values.data_ptr(), x.data_ptr(),
            split.owner.data_ptr(), split.begin.data_ptr(), split.end.data_ptr(),
            split.split_ptr.data_ptr(), y.data_ptr(),
            None if partial is None else partial.data_ptr(), m, split.n_wide,
            split.owner.numel(), split.n_split, split.n_split_pieces,
            int(values.dtype == torch.float64), stream)
    _check(err, "csr_matvec", "csr_matvec")
    csr_matvec.launches += 1
    return y


csr_matvec.launches = 0

KERNELS = {"tv_denoise_chw": tv_denoise_chw, "tv_denoise_chw_vjp": tv_denoise_chw_vjp,
           "freq_divide": freq_divide,
           "fused_admm_update": fused_admm_update, "bdot": bdot,
           "fused_cg_tail": fused_cg_tail, "bsr_matvec": bsr_matvec,
           "csr_matvec": csr_matvec, **{fn.__name__: fn for fn in MCG_KERNELS}}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    freq_divide.complex_launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset; ``freq_divide_complex``
    is the part of ``freq_divide``'s made by its complex-divisor entry."""
    return {**{name: fn.launches for name, fn in KERNELS.items()},
            "freq_divide_complex": freq_divide.complex_launches}

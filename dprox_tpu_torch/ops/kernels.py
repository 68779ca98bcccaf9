"""Hand-written Hopper kernels of the port, their wrappers and plain versions.

Each kernel replaces one Pallas TPU kernel of dprox_tpu/ops/pallas_kernels.py:

* ``tv_denoise_chw`` (csrc/tv_denoise.cu) <- ``tv_denoise_chw_pallas``:
  every TV dual-ascent iteration fused in shared memory;
* ``freq_divide`` (csrc/freq_divide.cu) <- ``freq_divide``: the
  frequency-diagonal divide of the x-update;
* ``fused_admm_update`` (csrc/fused_admm_update.cu) <- ``fused_admm_update``:
  the nonneg / soft-threshold prox and the ADMM dual update in one pass;
* ``bdot`` (csrc/bdot.cu) <- ``bdot_pallas``: per-batch dot products,
  deterministic;
* ``fused_cg_tail`` (csrc/cg_tail.cu) <- ``fused_cg_tail``: one CG
  iteration minus the matvec (both reductions and the three axpys).

The sources in ``csrc/`` are CUDA C++ for ``sm_90a`` with a plain C
interface (``reduce.cuh`` is the header ``bdot.cu`` and ``cg_tail.cu``
share). ``build()`` compiles each into its own shared library with
``nvcc`` (all sources at once, in parallel) under ``build/kernels/`` at
first use, and the wrappers call them through ``ctypes`` with
``data_ptr()`` pointers on PyTorch's current stream. A wrapper takes the
plain PyTorch version only for CPU tensors; for a CUDA tensor it
launches its kernel or raises. Each wrapper counts its launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..models.tv import tv_denoising_chw

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"tv_denoise": "tv_denoise.cu", "freq_divide": "freq_divide.cu",
           "fused_admm_update": "fused_admm_update.cu", "bdot": "bdot.cu",
           "cg_tail": "cg_tail.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "tv_denoise": {
        "dprox_tv_denoise_chw": [_P, _P, _I, _P, _I, _I, _I, _I, _P],
        "dprox_tv_max_iterations": [],
    },
    "freq_divide": {
        "dprox_freq_divide": [_P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _LL,
                              _P, _I, _F, _P, _I, _I, _I, _I, _P],
    },
    "fused_admm_update": {
        "dprox_fused_admm_update": [_P, _P, _P, _I, _I, _P, _P, _LL, _LL, _P],
    },
    "bdot": {
        "dprox_bdot": [_P, _P, _P, _P, _I, _LL, _P],
        "dprox_bdot_workspace": [_I, _LL],
    },
    "cg_tail": {
        "dprox_cg_tail": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _P],
        "dprox_cg_tail_workspace": [_I, _LL],
    },
}
_ERROR_STRING = {"tv_denoise": "dprox_tv_error_string",
                 "freq_divide": "dprox_freq_divide_error_string",
                 "fused_admm_update": "dprox_fused_admm_update_error_string",
                 "bdot": "dprox_bdot_error_string",
                 "cg_tail": "dprox_cg_tail_error_string"}

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
        ptxas = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]
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
            getattr(lib, fn).restype = ctypes.c_int
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
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type == "cpu"


# --------------------------------------------------------------------------- #
# Fused TV dual ascent
# --------------------------------------------------------------------------- #

#: plain PyTorch version of ``tv_denoise_chw`` (same function and op order)
tv_denoise_chw_plain = tv_denoising_chw


def tv_max_iterations() -> int:
    """Largest ``iterations`` the TV kernel takes on the current card (its
    halo window must fit in one block's shared memory)."""
    return _lib("tv_denoise").dprox_tv_max_iterations()


def tv_denoise_chw(y0: torch.Tensor, lam, iterations: int = 10) -> torch.Tensor:
    """TV dual ascent on [planes, H, W] float32, every iteration fused.

    ``lam``: float32 device tensor holding one value or one per plane. On
    CPU tensors this is ``models.tv.tv_denoising_chw``.
    """
    if _on_cpu(y0):
        return tv_denoise_chw_plain(y0, lam, iterations)
    _cuda_tensor(y0, "y0", torch.float32, y0.device, ndim=3)
    planes, H, W = y0.shape
    per_plane = _per_item_scalar(lam, "lam", planes, y0.device)
    iterations = int(iterations)
    limit = tv_max_iterations()
    if not 1 <= iterations <= limit:
        raise ValueError(f"tv_denoise_chw kernel takes 1..{limit} iterations "
                         f"on this card, got {iterations}")
    out = torch.empty_like(y0)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("tv_denoise").dprox_tv_denoise_chw(
            y0.data_ptr(), lam.data_ptr(), per_plane, out.data_ptr(),
            planes, H, W, iterations, stream)
    _check(err, "tv_denoise", "tv_denoise_chw")
    tv_denoise_chw.launches += 1
    return out


tv_denoise_chw.launches = 0


# --------------------------------------------------------------------------- #
# Frequency-diagonal divide
# --------------------------------------------------------------------------- #

def freq_divide_plain(F, diag, rho, eps: float = 1e-7):
    """Plain PyTorch version of ``freq_divide``."""
    return (F + eps) / (diag + rho + eps)


def freq_divide(F: torch.Tensor, diag: torch.Tensor, rho: torch.Tensor,
                eps: float = 1e-7) -> torch.Tensor:
    """``(F + eps) / (diag + rho + eps)`` for complex64 F [B, C, H, W].

    F and ``diag`` (real float32, broadcastable to F) are read through
    their strides, so a broadcast, sliced or permuted view costs no copy;
    ``rho``: float32 device tensor holding one value or one per batch
    element. The result is contiguous.
    """
    if _on_cpu(F):
        return freq_divide_plain(F, diag, rho, eps)
    _cuda_tensor(F, "F", torch.complex64, F.device, ndim=4, contiguous=False)
    _cuda_tensor(diag, "diag", torch.float32, F.device, contiguous=False)
    B, C, H, W = F.shape
    per_batch = _per_item_scalar(rho, "rho", B, F.device)
    d = torch.broadcast_to(diag, F.shape)
    out = torch.empty(F.shape, dtype=F.dtype, device=F.device)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("freq_divide").dprox_freq_divide(
            F.data_ptr(), *F.stride(), d.data_ptr(), *d.stride(), rho.data_ptr(), per_batch,
            float(eps), out.data_ptr(), B, C, H, W, stream)
    _check(err, "freq_divide", "freq_divide")
    freq_divide.launches += 1
    return out


freq_divide.launches = 0


# --------------------------------------------------------------------------- #
# Fused ADMM consensus update
# --------------------------------------------------------------------------- #

_ADMM_KINDS = {"nonneg": 0, "soft": 1}


def _float32_only(t, what: str):
    """The three solver kernels take float32; float64 and complex states
    belong to solves that are not ported yet."""
    if t.dtype in (torch.float64, torch.complex64, torch.complex128):
        raise NotImplementedError(
            f"{what} is {t.dtype}: the CUDA kernel takes float32 only; float64 "
            "and complex solver states come with the CS-MRI slice")


def _rows(ts, names):
    """Checks same-shape contiguous float32 [B, ...] CUDA operands; returns
    (B, D)."""
    first = ts[0]
    for t, name in zip(ts, names):
        _float32_only(t, name)
        _cuda_tensor(t, name, torch.float32, first.device)
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
    """Plain PyTorch version of ``fused_admm_update``."""
    w = Kx + u
    if kind == "nonneg":
        v = torch.clamp(w, min=0.0)
    elif kind == "soft":
        lam = _per_batch(torch.as_tensor(lam, dtype=w.dtype, device=w.device), w)
        v = torch.sign(w) * torch.clamp(torch.abs(w) - lam, min=0.0)
    else:
        raise ValueError(f"kind must be 'nonneg' or 'soft', got {kind!r}")
    return v, u + Kx - v


def fused_admm_update(Kx: torch.Tensor, u: torch.Tensor, lam: torch.Tensor,
                      kind: str = "nonneg"):
    """``v = prox(Kx + u)``, ``u' = u + Kx - v`` in one pass; returns
    ``(v, u')`` as new tensors, equal to the unfused form exactly.

    ``kind``: "nonneg" (``max(w, 0)``; ``lam`` is neither checked nor
    read, as the plain version ignores it) or "soft"
    (``sign(w) * max(|w| - lam, 0)``). Kx, u: contiguous float32 of one
    shape, batch leading; ``lam``: float32 tensor on their device holding
    one value or one per batch element.
    """
    if kind not in _ADMM_KINDS:
        raise ValueError(f"kind must be 'nonneg' or 'soft', got {kind!r}")
    if _on_cpu(Kx):
        return fused_admm_update_plain(Kx, u, lam, kind)
    B, D = _rows((Kx, u), ("Kx", "u"))
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


fused_admm_update.launches = 0


# --------------------------------------------------------------------------- #
# Batched dot product and the fused CG tail
# --------------------------------------------------------------------------- #

def bdot_plain(p, q):
    """Plain PyTorch version of ``bdot``."""
    B = p.shape[0]
    return torch.sum(p.reshape(B, -1) * q.reshape(B, -1), dim=1)


def bdot(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-batch dot products ``<p_b, q_b>`` over every dim but the first;
    returns [B].

    On the card: contiguous float32 operands, float32 accumulation, and a
    fixed summation order (no atomics), so two calls give the same bits.
    """
    if _on_cpu(p):
        return bdot_plain(p, q)
    B, D = _rows((p, q), ("p", "q"))
    lib = _lib("bdot")
    out = torch.empty(B, dtype=torch.float32, device=p.device)
    work = torch.empty(lib.dprox_bdot_workspace(B, D), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dprox_bdot(p.data_ptr(), q.data_ptr(), out.data_ptr(), work.data_ptr(),
                             B, D, stream)
    _check(err, "bdot", "bdot")
    bdot.launches += 1
    return out


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


def fused_cg_tail(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                  Ap: torch.Tensor, rs: torch.Tensor):
    """One CG iteration minus the matvec, per batch element:
    ``alpha = rs / max(<p, Ap>, 1e-32)``, ``x' = x + alpha p``,
    ``r' = r - alpha Ap``, ``rs' = <r', r'>``, ``beta = rs' / max(rs, 1e-32)``,
    ``p' = r' + beta p``; returns ``(x', r', p', rs')`` as new tensors.

    x, r, p, Ap: contiguous float32 [B, ...] of one shape; rs: float32 [B].
    The scalars stay on the device and the sums have a fixed order. (The
    kernel itself may also write x', r', p' over x, r, p; this wrapper
    does not.)
    """
    if _on_cpu(x):
        return fused_cg_tail_plain(x, r, p, Ap, rs)
    B, D = _rows((x, r, p, Ap), ("x", "r", "p", "Ap"))
    _float32_only(rs, "rs")
    _cuda_tensor(rs, "rs", torch.float32, x.device, ndim=1)
    if rs.numel() != B:
        raise ValueError(f"rs must hold {B} values, got {rs.numel()}")
    lib = _lib("cg_tail")
    x_out, r_out, p_out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    rs_out = torch.empty_like(rs)
    work = torch.empty(lib.dprox_cg_tail_workspace(B, D), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dprox_cg_tail(x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(),
                                rs.data_ptr(), x_out.data_ptr(), r_out.data_ptr(),
                                p_out.data_ptr(), rs_out.data_ptr(), work.data_ptr(),
                                B, D, stream)
    _check(err, "cg_tail", "fused_cg_tail")
    fused_cg_tail.launches += 1
    return x_out, r_out, p_out, rs_out


fused_cg_tail.launches = 0

KERNELS = {"tv_denoise_chw": tv_denoise_chw, "freq_divide": freq_divide,
           "fused_admm_update": fused_admm_update, "bdot": bdot,
           "fused_cg_tail": fused_cg_tail}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}

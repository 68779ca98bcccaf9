"""Preconditioned CG on ``mosaic(conv(x))`` plus rho terms, a kernel a stage.

The x-update of joint demosaicking and deconvolution solves

    (K^T K + n_rho * rho I) x = b,   K = Bayer mask * circular convolution,

by ``pcg`` with the frequency-Jacobi preconditioner M^-1 r = F^-1(F r /
Mdiag) (proxfn/sum_squares.py::least_squares.solve_cg). This is the same
iteration with the same stop rule, iteration count and result, but each
elementwise stage between two FFTs is one call of an ``ops.kernels.mcg_*``
wrapper (csrc/mosaic_pcg.cu on the card, a plain PyTorch version on the
CPU). An iteration is six complex-to-complex FFTs of the field's planes
(four in the matvec, two in M^-1), eight stage kernels and two ``bdot``
calls; the set-up is the same matvec, M^-1 and one ``bdot``. The inverse
FFTs run unscaled (``norm="forward"``) and the next stage scales by 1 / (H
W), so no FFT call adds a pass of its own. The buffers are made once a
solve; the host reads the stop test once an iteration, after the next
direction is queued, as ``pcg`` does.

``least_squares.solve_cg`` hands this solve to ``linalg.linear_solve`` where
it sees that structure (``mosaic_conv_system``), so the implicit gradient's
transposed solve runs it too. Each solve adds one to the program counter
``linalg.structured_pcg_solves`` and, as every solver does,
``linalg.solves`` and ``linalg.iterations``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import kernels
from ..utils.profiling import count
from .solvers import _tally

Array = torch.Tensor


def _spectrum(t: Array) -> Array:
    return torch.fft.fftn(t, dim=(-2, -1))


def _inverse_unscaled(t: Array) -> Array:
    return torch.fft.ifftn(t, dim=(-2, -1), norm="forward")


def gram_spectrum(otf: Array, src_c: Array, scale: float) -> Array:
    """K^T K's two FFT round trips on the complex field ``src_c``: the
    unscaled inverse of conj(OTF) F(mask Re(scale F^-1(OTF F(src_c)))), for
    ``mcg_gram`` or ``mcg_residual`` to finish."""
    g = _inverse_unscaled(kernels.mcg_otf_apply(_spectrum(src_c), otf, False))
    y = kernels.mcg_mask(g, scale)
    return _inverse_unscaled(kernels.mcg_otf_apply(_spectrum(y), otf, True))


def _precondition(r_c: Array, mdiag: Array, scale: float, z: Array) -> Array:
    """z = M^-1 r = scale Re F^-1(F r_c / mdiag)."""
    zc = _inverse_unscaled(kernels.mcg_precond(_spectrum(r_c), mdiag))
    return kernels.mcg_real(zc, scale, z)


def mosaic_conv_pcg(otf: Array, n_rho: int, rho: Array, mdiag: Array, b: Array,
                    x0: Optional[Array] = None, rtol: float = 1e-6,
                    max_iters: int = 100) -> Array:
    """``linalg.pcg(A, b, Minv, x0, rtol, max_iters)`` for A p = K^T K p +
    n_rho rho p and Minv r = F^-1(F r / mdiag).

    ``otf``: [1, C, H, W] complex64, contiguous; ``b`` and ``x0`` [B, C, H,
    W] float32, contiguous, C = 3 (the RGGB mask); ``rho`` float32 holding
    one value or one per batch element; ``mdiag`` float32 [1 or B, C, H, W],
    contiguous. ``x0`` is not written."""
    with torch.no_grad():
        B, C, H, W = b.shape
        scale = float(np.float32(1.0 / (H * W)))
        f32 = dict(dtype=torch.float32, device=b.device)
        x, r, z, p, Ap = (torch.empty_like(b) for _ in range(5))
        # one complex field: x's, then r's after the matvec has read p's
        c = torch.empty(b.shape, dtype=torch.complex64, device=b.device)
        rmax, bmax, pAp = (torch.empty(B, **f32) for _ in range(3))
        rz, rz_next = torch.empty(B, **f32), torch.empty(B, **f32)
        flag = torch.empty(1, dtype=torch.int32, device=b.device)
        work = kernels.bdot_workspace(b)

        x, c = kernels.mcg_start(x0, b, x, c, rmax, bmax)
        r, c, rmax, bmax = kernels.mcg_residual(gram_spectrum(otf, c, scale), b, x, rho, n_rho,
                                                scale, r, c, rmax, bmax)
        z = _precondition(c, mdiag, scale, z)
        rz = kernels.bdot(r, z, out=rz, workspace=work)
        p, c, flag = kernels.mcg_direction(z, p, rz, rz, c, rmax, bmax, rtol, flag, first=True)
        k = 0
        while k < max_iters and bool(flag.item()):
            Ap = kernels.mcg_gram(gram_spectrum(otf, c, scale), p, rho, n_rho, scale, Ap, rmax)
            pAp = kernels.bdot(p, Ap, out=pAp, workspace=work)
            x, r, c, rmax = kernels.mcg_step(x, r, p, Ap, rz, pAp, c, rmax)
            z = _precondition(c, mdiag, scale, z)
            rz_new = kernels.bdot(r, z, out=rz_next, workspace=work)
            p, c, flag = kernels.mcg_direction(z, p, rz_new, rz, c, rmax, bmax, rtol, flag)
            rz, rz_next = rz_new, rz
            k += 1
    count("linalg.structured_pcg_solves")
    _tally(k)
    return x

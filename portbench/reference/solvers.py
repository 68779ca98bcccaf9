"""The plain reference's solvers: ADMM, the frequency x-update and the
preconditioned CG x-update, in plain PyTorch.

The scaled ADMM of Boyd et al. (section 3.1.1) on f(x) + g(v), x = v:

    x <- argmin_x f(x) + rho ||x - (v - u)||^2      (the x-update)
    v <- prox_g(x + u, lam)                          (the prior)
    u <- u + x - v

with f = ||K x - b||^2, so the x-update solves (K^T K + rho) x = K^T b +
rho (v - u). Where K is a circular convolution the system is diagonal in
frequency and is divided there (with the numerator's conj(H) F(b) formed
in frequency, never round-tripped through space); otherwise it is solved
by conjugate gradients preconditioned in frequency by the circulant
surrogate of K^T K + rho, warm-started from the previous x, stopped when
max |r| <= rtol max |K^T b + rho (v - u)| or at the cap.

``q``, where given, rounds every stored vector after each update: the
harness's lower-precision control stores them in bfloat16.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def _same(t: Tensor) -> Tensor:
    return t


def admm(x0: Tensor, rhos: Tensor, lams: Tensor, x_update: Callable, prior: Callable,
         q: Callable = _same) -> Tensor:
    """``x_update(z, rho, x_prev)`` and ``prior(w, lam)``; returns x."""
    x, v, u = x0, x0, torch.zeros_like(x0)
    for k in range(len(rhos)):
        x = q(x_update(v - u, rhos[k], x))
        v = q(prior(x + u, lams[k]))
        u = q(u + x - v)
    return x


def freq_xupdate(Hb_hat: Tensor, H2: Tensor, eps: float = 1e-7) -> Callable:
    """x = real(ifft2((conj(H) F(b) + F(rho z) + eps) / (|H|^2 + rho + eps)))."""
    def update(z, rho, x_prev):
        num = Hb_hat + torch.fft.fft2(rho * z)
        return torch.fft.ifft2((num + eps) / (H2 + rho + eps)).real
    return update


def _bdot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum((a * b).reshape(a.shape[0], -1), dim=1)


def _bmax(t: Tensor) -> Tensor:
    return t.reshape(t.shape[0], -1).abs().amax(dim=1)


def _col(s: Tensor, like: Tensor) -> Tensor:
    return s.reshape((-1,) + (1,) * (like.ndim - 1))


def pcg(A: Callable, rhs: Tensor, Minv: Callable, x0: Tensor, rtol: float, max_iters: int,
        q: Callable = _same, iterations: Optional[list] = None) -> Tensor:
    """Preconditioned CG on the SPD operator ``A``, batched, stopping when
    every batch element has max |r| <= rtol max |rhs|."""
    x = x0
    r = q(rhs - A(x))
    z = q(Minv(r))
    p = z
    rz = _bdot(r, z)
    tol = rtol * torch.clamp(_bmax(rhs), min=1e-32)
    k = 0
    while k < max_iters and bool((_bmax(r) > tol).any()):
        Ap = A(p)
        alpha = rz / torch.clamp(_bdot(p, Ap), min=1e-32)
        x = q(x + _col(alpha, x) * p)
        r = q(r - _col(alpha, r) * Ap)
        z = q(Minv(r))
        rz_new = _bdot(r, z)
        p = q(z + _col(rz_new / torch.clamp(rz, min=1e-32), p) * p)
        rz = rz_new
        k += 1
    if iterations is not None:
        iterations.append(k)
    return x


def cg_xupdate(K: Callable, Kt: Callable, Ktb: Tensor, surrogate: Tensor, rtol: float,
               max_iters: int, q: Callable = _same, iterations: Optional[list] = None
               ) -> Callable:
    """x-update by ``pcg`` on K^T K + rho with M = surrogate + rho, M^-1 r =
    real(ifft2(F(r) / M))."""
    def update(z, rho, x_prev):
        A = lambda v: Kt(K(v)) + rho * v  # noqa: E731
        Minv = lambda r: torch.fft.ifft2(torch.fft.fft2(r) / (surrogate + rho)).real  # noqa: E731
        return pcg(A, Ktb + rho * z, Minv, x_prev, rtol, max_iters, q, iterations)
    return update

"""Fixed-point engines: Anderson acceleration and Broyden's method.

Counterpart of dprox_tpu/algo/special/fixed_point.py. Anderson keeps m = 6
iterates and mixes them by regularized least squares; its first steps
(while the history grows) run without a stop test, then it stops when the
relative residual ||f(x) - x|| / (1e-5 + ||f(x)||), one norm over the
whole batch, falls below ``eps``. Broyden keeps rank-one updates of the
inverse Jacobian in a fixed-size buffer.

Each stop test is one host read (the JAX package tests on the device inside
a while_loop). The small (m+1)^2 systems go through
``torch.linalg.solve_ex``, which, unlike ``solve``, does not read its
``info`` back to the host. ``stats``, where given, is filled with the
number of evaluations of f (``"evaluations"``) and the residual after each
one that has one (``"res"``, host floats).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _flat(x):
    return x.reshape(x.shape[0], -1)


def _mix_weights(X, F, lam, rhs):
    """Anderson's mixing weights [B, n] for the n entries of X, F [B, n, D]."""
    bsz, n = X.shape[:2]
    G = F - X
    Hm = torch.einsum("bnd,bmd->bnm", G, G.conj()) + lam * torch.eye(
        n, dtype=X.dtype, device=X.device)
    H = torch.zeros((bsz, n + 1, n + 1), dtype=X.dtype, device=X.device)
    H[:, 0, 1:] = 1.0
    H[:, 1:, 0] = 1.0
    H[:, 1:, 1:] = Hm
    return torch.linalg.solve_ex(H, rhs[:, :n + 1])[0][:, 1:, 0]


def anderson(f: Callable, x0: torch.Tensor, m: int = 6, lam: float = 1e-4,
             threshold: int = 50, eps: float = 1e-3, beta: float = 1.0,
             stats: Optional[dict] = None):
    """Anderson acceleration; returns the final iterate. ``f`` maps a
    tensor shaped like x0 ([B, ...]) to one of the same shape."""
    bsz = x0.shape[0]
    orig_shape = x0.shape
    evaluations, history = 0, []

    def ff(v):  # flat -> flat
        nonlocal evaluations
        evaluations += 1
        return _flat(f(v.reshape(orig_shape)))

    x0f = _flat(x0)
    f0 = ff(x0f)
    # the buffers take the map's output dtype (a complex state from a real x0)
    dtype = torch.result_type(x0f, f0)
    D = x0f.shape[1]
    X = torch.zeros((bsz, m, D), dtype=dtype, device=x0.device)
    F = torch.zeros_like(X)
    X[:, 0] = x0f.to(dtype)
    F[:, 0] = f0.to(dtype)
    X[:, 1] = F[:, 0]
    F[:, 1] = ff(F[:, 0]).to(dtype)
    rhs = torch.zeros((bsz, m + 1, 1), dtype=dtype, device=x0.device)
    rhs[:, 0] = 1.0

    def mix(k, n):
        """One Anderson update over the first n history entries, written to
        slot k % m; returns the relative residual as a device scalar."""
        alpha = _mix_weights(X[:, :n], F[:, :n], lam, rhs)
        xk = beta * torch.einsum("bn,bnd->bd", alpha, F[:, :n])
        if beta != 1.0:
            xk = xk + (1 - beta) * torch.einsum("bn,bnd->bd", alpha, X[:, :n])
        fk = ff(xk).to(dtype)
        X[:, k % m] = xk
        F[:, k % m] = fk
        return torch.linalg.vector_norm(fk - xk) / (1e-5 + torch.linalg.vector_norm(fk))

    # phase 1: growing history, no stop test
    k = 2
    res = None
    while k < min(threshold, m):
        res = mix(k, k)
        k += 1
    if threshold > m:
        # phase 2: full window, one host read of the residual a step
        res = float("inf") if res is None else float(res)
        history.append(res)
        while k < threshold and res >= eps:
            res = float(mix(k, m))
            history.append(res)
            k += 1
    if stats is not None:
        stats.update(evaluations=evaluations, res=history)
    return X[:, (k - 1) % m].reshape(orig_shape).clone()


def broyden(f: Callable, x0: torch.Tensor, threshold: int = 40, eps: float = 1e-3,
            stats: Optional[dict] = None):
    """Broyden's method with rank-one inverse-Jacobian updates (no line
    search, as the JAX package); stops when ||g(x)|| / (1e-9 + ||g(x) + x||)
    falls below ``eps``, g(x) = f(x) - x."""
    bsz = x0.shape[0]
    orig_shape = x0.shape
    evaluations, history = 0, []

    def g(v):
        nonlocal evaluations
        evaluations += 1
        return _flat(f(v.reshape(orig_shape))) - v

    x = _flat(x0)
    gx = g(x)
    D = x.shape[1]
    Us = torch.zeros((bsz, D, threshold), dtype=x0.dtype, device=x0.device)
    VTs = torch.zeros((bsz, threshold, D), dtype=x0.dtype, device=x0.device)

    def matvec(v):  # (-I + U V^T) v
        return -v + torch.einsum("bdk,bk->bd", Us, torch.einsum("bkd,bd->bk", VTs, v))

    def rmatvec(v):
        return -v + torch.einsum("bkd,bk->bd", VTs, torch.einsum("bdk,bd->bk", Us, v))

    update = -matvec(gx)
    k = 0
    while k < threshold:
        res = float(torch.linalg.vector_norm(gx) / (1e-9 + torch.linalg.vector_norm(gx + x)))
        history.append(res)
        if res < eps:
            break
        x_new = x + update
        gx_new = g(x_new)
        dx, dg = x_new - x, gx_new - gx
        vT = rmatvec(dx)
        denom = torch.einsum("bd,bd->b", vT, dg)[:, None]
        u = (dx - matvec(dg)) / torch.where(denom.abs() < 1e-12, denom.new_full((), 1e-12), denom)
        Us[:, :, k] = torch.nan_to_num(u)
        VTs[:, k] = torch.nan_to_num(vT)
        x, gx = x_new, gx_new
        update = -matvec(gx)
        k += 1
    if stats is not None:
        stats.update(evaluations=evaluations, res=history)
    return x.reshape(orig_shape)


FIXED_POINT_SOLVERS = {"anderson": anderson, "broyden": broyden}

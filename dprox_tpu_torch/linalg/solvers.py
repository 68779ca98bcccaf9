"""Matrix-free iterative solvers: batched CG, CG2, PCG, PLSS, MINRES.

Counterpart of dprox_tpu/linalg/solvers.py. Each solver works on
unknowns of shape [B, ...] with per-batch inner products, an iteration
cap and an all-batch stop rule (the loop runs until every batch element
meets its tolerance). The JAX package runs them as ``lax.while_loop``;
here they are eager Python ``while`` loops with the same condition, and
reading that condition costs one device-to-host sync per iteration. The
implicit-gradient wrapper in ``solve.py`` means these loops are never
differentiated through; they run without autograd. The exception is
``cg_unrolled``: a fixed number of iterations with no host read, which
plain autograd differentiates (the LP path's hyperparameter pretraining).

``bdot`` is the batched-dot kernel (ops/kernels.py::bdot) for CUDA
float32 or float64 operands, differentiable in both, and plain torch for
CPU tensors.

Each solver adds one to the program counter ``linalg.solves`` and its
iteration count to ``linalg.iterations`` as it returns
(utils/profiling.py::counts); a ``cg``/``pcg`` solve of k iterations reads
its stop test from the host k + 1 times.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import kernels
from ..ops.kernels import fused_cg_tail
from ..utils.profiling import count

Array = torch.Tensor


def _tally(iterations: int) -> None:
    count("linalg.solves")
    count("linalg.iterations", iterations)


def bdot(x: Array, y: Array) -> Array:
    """Per-batch dot product: contract all dims except the leading one."""
    return kernels.bdot(x.contiguous(), y.contiguous())


def _bexpand(s: Array, like: Array) -> Array:
    """[B] -> [B,1,...,1] broadcastable against ``like``."""
    return s.reshape((-1,) + (1,) * (like.ndim - 1))


def _clamp(s, lo: float = 1e-32):
    return torch.clamp(s, min=lo)


def cg(A: Callable, b: Array, x0: Optional[Array] = None, rtol: float = 1e-6,
       max_iters: int = 100, verbose: bool = False) -> Array:
    """Batched conjugate gradient for SPD A (matrix-free).

    Stops when every batch satisfies ||r|| <= rtol * ||b||, or at
    ``max_iters``.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    p = r
    rs = bdot(r, r)
    tol = rtol * _clamp(torch.sqrt(bdot(b, b)))
    k = 0
    while k < max_iters and bool((torch.sqrt(rs) > tol).any()):
        Ap = A(p)
        alpha = rs / _clamp(bdot(p, Ap))
        x = x + _bexpand(alpha, x) * p
        r = r - _bexpand(alpha, r) * Ap
        rs_new = bdot(r, r)
        beta = rs_new / _clamp(rs)
        p = r + _bexpand(beta, p) * p
        rs = rs_new
        k += 1
    _tally(k)
    return x


def cg_unrolled(A: Callable, b: Array, x0: Optional[Array] = None,
                rtol: float = 1e-6, max_iters: int = 100) -> Array:
    """CG with a fixed trip count and no host read, differentiable by
    plain autograd. Batch elements that have converged are frozen by
    masking, so further iterations leave them where they are."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    p = r
    rs = bdot(r, r)
    tol = rtol * _clamp(torch.sqrt(bdot(b, b)))
    zero, one = torch.zeros_like(rs), torch.ones_like(rs)
    for _ in range(max_iters):
        active = torch.sqrt(rs) > tol
        Ap = A(p)
        pAp = bdot(p, Ap)
        # safe denominators: a masked-out element must not divide by ~0, or
        # torch.where passes NaN into the backward pass
        alpha = torch.where(active, rs, zero) / torch.where(active, pAp, one)
        x = x + _bexpand(alpha, x) * p
        r = r - _bexpand(alpha, r) * Ap
        rs_new = torch.where(active, bdot(r, r), rs)
        beta = torch.where(active, rs_new, zero) / torch.where(active, rs, one)
        p = r + _bexpand(beta, p) * p
        rs = rs_new
    _tally(max_iters)
    return x


def cg2(A: Callable, b: Array, x0: Optional[Array] = None, rtol: float = 1e-6,
        max_iters: int = 100, verbose: bool = False) -> Array:
    """Plain (non-batched-stop) CG variant; global residual stopping."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    p = r
    rs = torch.vdot(r.reshape(-1), r.reshape(-1))
    tol2 = (rtol ** 2) * _clamp(torch.vdot(b.reshape(-1), b.reshape(-1)))
    k = 0
    while k < max_iters and bool(rs > tol2):
        Ap = A(p)
        alpha = rs / _clamp(torch.vdot(p.reshape(-1), Ap.reshape(-1)))
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.vdot(r.reshape(-1), r.reshape(-1))
        p = r + (rs_new / _clamp(rs)) * p
        rs = rs_new
        k += 1
    _tally(k)
    return x


def _bmax(t: Array) -> Array:
    return t.reshape(t.shape[0], -1).abs().amax(dim=1)


def pcg(A: Callable, b: Array, Minv: Optional[Callable] = None,
        x0: Optional[Array] = None, rtol: float = 1e-6, max_iters: int = 100,
        verbose: bool = False) -> Array:
    """Preconditioned CG with inf-norm relative stop."""
    if Minv is None:
        Minv = lambda v: v
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = Minv(r)
    p = z
    rz = bdot(r, z)
    tol = rtol * _clamp(_bmax(b))
    k = 0
    while k < max_iters and bool((_bmax(r) > tol).any()):
        Ap = A(p)
        alpha = rz / _clamp(bdot(p, Ap))
        x = x + _bexpand(alpha, x) * p
        r = r - _bexpand(alpha, r) * Ap
        z = Minv(r)
        rz_new = bdot(r, z)
        beta = rz_new / _clamp(rz)
        p = z + _bexpand(beta, p) * p
        rz = rz_new
        k += 1
    _tally(k)
    return x


def plss(A: Callable, b: Array, AT: Optional[Callable] = None,
         x0: Optional[Array] = None, rtol: float = 1e-6, max_iters: int = 100,
         verbose: bool = False) -> Array:
    """Projected Linear Systems Solver (SIAM 22M1509783), batched.

    Handles general systems matrix-free; needs the adjoint ``AT``
    (defaults to A for self-adjoint operators). The min-residual iterate
    is tracked per batch element.
    """
    return plssw(A, b, None, AT, x0, rtol, max_iters)


def plssw(A: Callable, b: Array, Wh: Optional[Array] = None,
          AT: Optional[Callable] = None, x0: Optional[Array] = None,
          rtol: float = 1e-6, max_iters: int = 100, verbose: bool = False) -> Array:
    """Weighted PLSS for ill-conditioned systems. ``Wh`` is the diagonal
    weight; without it this is plain ``plss``."""
    if AT is None:
        AT = A
    if Wh is None:
        W = Wi = lambda t: t
    else:
        Whi = torch.where(torch.isfinite(1.0 / Wh), 1.0 / Wh, torch.zeros_like(Wh))
        W, Wi = (lambda t: Wh * t), (lambda t: Whi * t)
    x = torch.zeros_like(b) if x0 is None else x0
    tol = rtol * _clamp(torch.sqrt(bdot(b, b)))

    def residual(x):
        c = A(x) - b
        return c, torch.sqrt(bdot(c, c))

    c, nc = residual(x)
    y = AT(c / _clamp(_bexpand(nc, c)))
    z = Wi(y)
    deltai = 1.0 / _clamp(bdot(z, z))
    p = -_bexpand(deltai * nc, z) * Wi(z)
    x = x + p
    x_min, nc_min = x, nc
    k = 1
    while True:
        c, nc = residual(x)
        if not (k < max_iters and bool((nc > tol).any())):
            break
        better = nc <= nc_min
        x_min = torch.where(_bexpand(better, x), x, x_min)
        nc_min = torch.where(better, nc, nc_min)

        y = AT(c / _clamp(_bexpand(nc, c)))
        z = Wi(y)
        Wp = W(p)
        p2 = bdot(Wp, Wp)
        nrp = torch.sqrt(p2)
        py = bdot(p, y)
        ny = torch.sqrt(bdot(z, z))
        denom = (nrp * ny - py) * (nrp * ny + py)
        denom = torch.where(denom.abs() < 1e-32, torch.full_like(denom, 1e-32), denom)
        beta1 = (nc * py) / denom
        beta2 = -(nc * p2) / denom
        p = _bexpand(beta1, p) * p + _bexpand(beta2, z) * Wi(z)
        x = x + p
        k += 1
    _tally(k)
    return torch.where(_bexpand(nc_min < nc, x), x_min, x)


def minres(A: Callable, b: Array, x0: Optional[Array] = None, rtol: float = 1e-6,
           max_iters: int = 100, shift: float = 0.0, verbose: bool = False) -> Array:
    """Batched MINRES for symmetric (possibly indefinite) systems:
    Paige-Saunders Lanczos + Givens recurrence, batched over the leading
    axis and capped at ``max_iters``."""
    x = torch.zeros_like(b) if x0 is None else x0
    r2 = b - (A(x) - shift * x) if x0 is not None else b  # r_k
    beta = torch.sqrt(bdot(r2, r2))
    tol = rtol * _clamp(torch.sqrt(bdot(b, b)))
    r1 = torch.zeros_like(b)  # r_{k-1}
    w0, w1 = torch.zeros_like(b), torch.zeros_like(b)  # w_{k-2}, w_{k-1}
    beta_prev = torch.zeros_like(beta)
    eta = resid = beta
    c_old, c = torch.ones_like(beta), torch.ones_like(beta)
    s_old, s = torch.zeros_like(beta), torch.zeros_like(beta)
    k = 0
    while k < max_iters and bool((resid > tol).any()):
        v = r2 / _clamp(_bexpand(beta, r2))
        Av = A(v) - shift * v
        alpha = bdot(v, Av)
        # three-term Lanczos recurrence
        r_next = Av - _bexpand(alpha / _clamp(beta), Av) * r2
        r_next = r_next - _bexpand(beta / _clamp(beta_prev) * (beta_prev > 0), r_next) * r1
        beta_next = torch.sqrt(bdot(r_next, r_next))

        # previous rotations applied to the new column of T
        delta1 = c * alpha - c_old * s * beta
        gamma = torch.sqrt(delta1 ** 2 + beta_next ** 2)
        eps = s_old * beta
        delta2 = s * alpha + c_old * c * beta
        c_next = delta1 / _clamp(gamma)
        s_next = beta_next / _clamp(gamma)

        w = v - _bexpand(eps, v) * w0 - _bexpand(delta2, v) * w1
        w = w / _clamp(_bexpand(gamma, w))
        x = x + _bexpand(c_next * eta, w) * w
        eta = -s_next * eta

        r1, r2, w0, w1 = r2, r_next, w1, w
        beta_prev, beta = beta, beta_next
        c_old, c, s_old, s = c, c_next, s, s_next
        resid = eta.abs()
        k += 1
    _tally(k)
    return x


def cg_pallas(A: Callable, b: Array, x0: Optional[Array] = None,
              rtol: float = 1e-6, max_iters: int = 100,
              verbose: bool = False) -> Array:
    """Batched CG whose per-iteration tail (both reductions and all three
    axpys) is ONE ``fused_cg_tail`` call (ops/kernels.py); only the matvec
    A(p) stays outside. Same math and stopping rule as :func:`cg`. The
    name is the JAX package's, kept so the two read side by side; the
    kernel here is CUDA."""
    x = torch.zeros_like(b) if x0 is None else x0.contiguous()
    r = b - A(x)
    p = r
    rs = bdot(r, r)
    tol = rtol * _clamp(torch.sqrt(bdot(b, b)))
    k = 0
    while k < max_iters and bool((torch.sqrt(rs) > tol).any()):
        x, r, p, rs = fused_cg_tail(x, r, p, A(p).contiguous(), rs)
        k += 1
    _tally(k)
    return x


SOLVERS = {
    "cg": cg,
    "cg2": cg2,
    "cg_pallas": cg_pallas,
    "pcg": pcg,
    "plss": plss,
    "plssw": plssw,
    "minres": minres,
}

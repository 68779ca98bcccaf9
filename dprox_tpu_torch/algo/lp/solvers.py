"""Learnable OSQP-style LP ADMM solver.

Counterpart of dprox_tpu/algo/lp/solvers.py. The iteration

    xtilde <- PCG((rho A^T A + sigma I), sigma x - c + A^T(rho z - y))
    x <- alpha xtilde + (1-alpha) x;  ztilde relaxed;  z = clip(., lb, ub)
    y <- y + rho (ztilde - z)

runs eagerly with a Jacobi-preconditioned warm-started PCG; A and A^T are
``BSRMat`` applies (the ``bsr_matvec`` kernel) or ``torch.sparse``
products. ``solve`` evaluates residuals, stops early and balances rho on
the host between chunks of ``eval_freq`` iterations and keeps a history;
``solve_fused`` keeps the convergence test and the rho adaptation on the
device and reads the host once per chunk. Hyperparameters (rho,
log sigma, alpha, gamma multipliers) are a dict of 0-d tensors optimized
by Adam on the log-residual convergence loss, through a truncated solve
with an unrolled CG, before the final solve (``solve_lp``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...linalg.solvers import cg_unrolled
from ...linalg.solvers import pcg as batched_pcg
from ...utils.misc import resolve_device
from .utils import ruiz_equilibration_sparse, scipy_to_device_op


def _vec_norm(x):
    return x.reshape(-1).abs().max()


def _clip(v, lb, ub):
    """min(max(v, lb), ub) with tensor bounds that may be infinite. Written
    with maximum/minimum, which split the gradient evenly between ``v`` and
    a bound they tie with, as the JAX package's ``jnp.clip`` does; a tie is
    common here (an iterate that sits exactly on its bound)."""
    return torch.minimum(torch.maximum(v, lb), ub)


def _rtol_schedule(dtype) -> np.ndarray:
    """The inner-CG tolerance schedule logspace(-6, -10) with a dtype-aware
    floor: below ~50 eps the stop is unreachable and PCG burns its full
    iteration cap doing roundoff arithmetic. In float64 the floor (1.1e-14)
    leaves the schedule untouched; in float32 it clamps at ~6e-6, far
    tighter than the outer ADMM tolerance."""
    return np.maximum(np.logspace(-6, -10, 10000), 50 * torch.finfo(dtype).eps)


def _sync(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class LPConvergenceLoss:
    """loss = log(r/eps_p) + log(s/eps_d)."""

    def __call__(self, r_norm, s_norm, eps_primal, eps_dual):
        # clamp: a residual that is already ~0 must not produce -inf/NaN grads
        rp = torch.clamp(r_norm / eps_primal, min=1e-12)
        sd = torch.clamp(s_norm / eps_dual, min=1e-12)
        return torch.log(rp) + torch.log(sd)


class LPProblem:
    """Preprocessed LP: stack [A_ub; A_eq; I], Ruiz-equilibrate on the host,
    build the device operators and bounds."""

    def __init__(self, c, A_ub, b_ub, A_eq, b_eq, x_lb=None, x_ub=None,
                 dtype=torch.float64, device="cuda"):
        n = c.shape[0]
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        if x_lb is None:
            x_lb = np.zeros(n)
        if x_ub is None:
            x_ub = np.full(n, np.inf)
        A_ub = sp.csr_matrix(A_ub) if A_ub is not None else sp.csr_matrix((0, n))
        A_eq = sp.csr_matrix(A_eq) if A_eq is not None else sp.csr_matrix((0, n))
        b_ub = np.zeros(0) if b_ub is None else np.asarray(b_ub).ravel()
        b_eq = np.zeros(0) if b_eq is None else np.asarray(b_eq).ravel()
        self.m_ub, self.m_eq, self.n = A_ub.shape[0], A_eq.shape[0], n

        A = sp.vstack([A_ub, A_eq, sp.eye(n)])
        d, e, gamma_c, gamma_b, A_bar, Acnorm = ruiz_equilibration_sparse(
            A, np.asarray(c, np.float64), np.concatenate([b_ub, b_eq, x_ub]))
        put = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device=dev, dtype=dtype)
        self.A_host = sp.csr_matrix(A_bar)
        self.A, self.AT = scipy_to_device_op(A_bar, dtype, device=dev)
        self.d = put(d)
        self.e = put(e)
        self.gamma_c = gamma_c
        self.gamma_b = gamma_b
        self.Acnorm = put(Acnorm)
        self.c = put(np.asarray(c).ravel())
        self.lb = put(np.concatenate([np.full(self.m_ub, -np.inf), b_eq, x_lb]))
        self.ub = put(np.concatenate([b_ub, b_eq, x_ub]))

    @property
    def problem_scale(self):
        return self.A.shape


class LPSolverADMM:
    def __init__(self, rho: float = 1.0, abstol: float = 1e-4,
                 reltol: float = 1e-3, max_iters: int = 20000,
                 dtype=torch.float64, verbose: bool = True):
        self.abstol = abstol
        self.reltol = reltol
        self.max_iters = max_iters
        self.dtype = dtype
        self.verbose = verbose
        self.rho0 = rho

    def init_params(self):
        """The five hyperparameters as 0-d tensors on the CPU. The solves
        move them to the problem's device."""
        values = {"rho": self.rho0, "sigma_log": np.log(1e-6), "alpha": 1.6,
                  "gamma_c_mul": 1.0, "gamma_b_mul": 1.0}
        return {k: torch.tensor(v, dtype=self.dtype) for k, v in values.items()}

    def _params(self, p: LPProblem, params):
        params = params if params is not None else self.init_params()
        return {k: torch.as_tensor(v, dtype=self.dtype).to(p.device)
                for k, v in params.items()}

    # ------------------------------------------------------------------ #

    def _prepare(self, p: LPProblem, params):
        gamma_c = params["gamma_c_mul"] * p.gamma_c
        gamma_b = params["gamma_b_mul"] * p.gamma_b
        c = gamma_c * (p.d * p.c)
        # mask infinities BEFORE scaling: inf * gamma inside the untaken
        # where-branch poisons gradients with NaNs
        zero = torch.zeros_like(p.lb)
        lb_inf = torch.isinf(p.lb)
        ub_inf = torch.isinf(p.ub)
        lb = torch.where(lb_inf, p.lb, torch.where(lb_inf, zero, p.lb) * gamma_b * p.e)
        ub = torch.where(ub_inf, p.ub, torch.where(ub_inf, zero, p.ub) * gamma_b * p.e)
        return c, lb, ub, gamma_c, gamma_b

    @staticmethod
    def _relax_and_project(A, carry, xt, rho, alpha, lb, ub):
        x, z, y, _ = carry
        zt = A @ xt
        x = alpha * xt + (1 - alpha) * x
        zt = alpha * zt + (1 - alpha) * z
        z = _clip(zt + y / rho, lb, ub)
        y = y + rho * (zt - z)
        return (x, z, y, xt)

    def _one_iter(self, p: LPProblem, carry, rtol, rho, c, sigma, alpha,
                  lb, ub, pcg_iters: int):
        """One OSQP-style iteration: Jacobi-preconditioned warm-started PCG
        x-update, relaxation, clip-to-bounds z, dual ascent."""
        A, AT = p.A, p.AT
        x, z, y, xtilde = carry
        right = sigma * x - c + (AT @ (rho * z - y))

        def KtK(v):  # batched interface: [1, n]
            return (AT @ (rho * (A @ v[0])) + sigma * v[0])[None]

        M = (sigma + rho * (p.Acnorm ** 2))[None]
        xt = batched_pcg(KtK, right[None], Minv=lambda r: r / M,
                         x0=xtilde[None], rtol=rtol, max_iters=pcg_iters)[0]
        return self._relax_and_project(A, carry, xt, rho, alpha, lb, ub)

    def _one_iter_unrolled(self, p: LPProblem, carry, rho, c, sigma, alpha,
                           lb, ub, unroll_pcg_iters: int):
        """The same iteration with a fixed-trip-count CG x-update that
        autograd can differentiate."""
        A, AT = p.A, p.AT
        x, z, y, xtilde = carry
        right = sigma * x - c + (AT @ (rho * z - y))

        def KtK(v):
            return (AT @ (rho * (A @ v[0])) + sigma * v[0])[None]

        xt = cg_unrolled(KtK, right[None], x0=xtilde[None], rtol=1e-12,
                         max_iters=unroll_pcg_iters)[0]
        return self._relax_and_project(A, carry, xt, rho, alpha, lb, ub)

    def _zero_carry(self, p: LPProblem):
        m, n = p.problem_scale
        zeros = lambda k: torch.zeros(k, dtype=self.dtype, device=p.device)
        return (zeros(n), zeros(m), zeros(m), zeros(n))

    def solve(self, problem: LPProblem, params: Optional[dict] = None,
              max_iters: Optional[int] = None, eval_freq: int = 25,
              residual_balance: bool = False, pcg_iters: int = 1000,
              differentiable: bool = False, unroll_pcg_iters: int = 20,
              polish: bool = False):
        """Run the ADMM loop in chunks of ``eval_freq`` iterations with the
        residuals read on the host after each; returns (x, history, results).
        Runs without autograd unless ``differentiable`` (which also swaps
        the PCG for the unrolled CG)."""
        p = problem
        params = self._params(p, params)
        max_iters = max_iters or self.max_iters
        dt = self.dtype
        rtols = torch.as_tensor(_rtol_schedule(dt)).to(device=p.device, dtype=dt)
        history = defaultdict(list)
        with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
            rho = params["rho"]
            sigma = torch.exp(params["sigma_log"])
            alpha = params["alpha"]
            c, lb, ub, gamma_c, gamma_b = self._prepare(p, params)
            evaluate = lambda x, z, y: torch.stack(  # one tensor = one host fetch
                self.eval_result(p, c, gamma_c, gamma_b, x, z, y)).tolist()

            carry = self._zero_carry(p)
            k = 0
            while k < max_iters:
                steps = min(eval_freq, max_iters - k)
                t0 = time.perf_counter()
                for i in range(steps):
                    if differentiable:
                        carry = self._one_iter_unrolled(p, carry, rho, c, sigma, alpha,
                                                        lb, ub, unroll_pcg_iters)
                    else:
                        carry = self._one_iter(p, carry, rtols[min(k + i, 9999)], rho, c,
                                               sigma, alpha, lb, ub, pcg_iters)
                k += steps
                x, z, y, xtilde = carry
                _sync(x)
                history["t_chunk"].append(time.perf_counter() - t0)
                objval, r_norm, s_norm, eps_p, eps_d = evaluate(x, z, y)
                history["r_norm"].append(r_norm)
                history["s_norm"].append(s_norm)
                history["eps_primal"].append(eps_p)
                history["eps_dual"].append(eps_d)
                history["objval"].append(objval)

                if residual_balance and k % 1000 == 0:
                    if r_norm > 10 * eps_p or eps_d > 10 * s_norm:
                        rho = rho * 2
                    elif s_norm > 10 * eps_d or eps_p > 10 * r_norm:
                        rho = rho / 2

                if self.verbose and k % 1000 < eval_freq:
                    print(f"k={k} obj={objval:.4e} r={r_norm:.2e} s={s_norm:.2e} "
                          f"eps_p={eps_p:.2e} eps_d={eps_d:.2e} rho={float(rho):.2e}")
                if r_norm < eps_p and s_norm < eps_d:
                    break

            if polish:
                x, z, y = self.solution_polishing(p, c, x, z, y)
                objval, r_norm, s_norm, eps_p, eps_d = evaluate(x, z, y)
            results = (objval, r_norm, s_norm, eps_p, eps_d)
            x_out = x * p.d / gamma_b
        return x_out, history, results

    @torch.no_grad()
    def solve_fused(self, problem: LPProblem, params: Optional[dict] = None,
                    max_iters: Optional[int] = None, eval_freq: int = 25,
                    residual_balance: bool = True, pcg_iters: int = 1000,
                    polish: bool = False):
        """The solve with its control on the device: the convergence test
        and the residual-balancing rho adaptation are tensor operations, and
        the loop reads the host once per chunk of ``eval_freq`` iterations
        (the ``done`` flag), never per ADMM iteration. (The stop test inside
        ``pcg`` still reads once per inner iteration.) No history is kept.
        Returns (x, results_dict); ``wall_s_incl_first_compile`` is the
        host-clock time of the loop, which on a first call includes building
        and loading the kernels.
        """
        p = problem
        params = self._params(p, params)
        max_iters = max_iters or self.max_iters
        dt = self.dtype
        rho = params["rho"]
        sigma = torch.exp(params["sigma_log"])
        alpha = params["alpha"]
        c, lb, ub, gamma_c, gamma_b = self._prepare(p, params)
        rtols = torch.as_tensor(_rtol_schedule(dt)).to(device=p.device, dtype=dt)

        t0 = time.perf_counter()
        carry = self._zero_carry(p)
        res = torch.full((5,), float("inf"), dtype=dt, device=p.device)
        k, done = 0, False
        while k < max_iters and not done:
            # clamp the chunk so max_iters is never overrun
            steps = min(eval_freq, max_iters - k)
            for i in range(steps):
                carry = self._one_iter(p, carry, rtols[min(k + i, 9999)], rho, c,
                                       sigma, alpha, lb, ub, pcg_iters)
            crossed_1000 = (k + steps) // 1000 > k // 1000
            k += steps
            x, z, y, xt = carry
            objval, r_norm, s_norm, eps_p, eps_d = self.eval_result(
                p, c, gamma_c, gamma_b, x, z, y)
            done_t = (r_norm < eps_p) & (s_norm < eps_d)
            if residual_balance and crossed_1000:
                # every 1000 iterations; fires when a 1000 boundary was
                # crossed this chunk, so any eval_freq works
                up = (r_norm > 10 * eps_p) | (eps_d > 10 * s_norm)
                dn = (s_norm > 10 * eps_d) | (eps_p > 10 * r_norm)
                rho = torch.where(~done_t & up, rho * 2,
                                  torch.where(~done_t & dn, rho / 2, rho))
            res = torch.stack([objval, r_norm, s_norm, eps_p, eps_d])
            done = bool(done_t)  # the chunk's one host read
        x, z, y, xt = carry
        res = res.tolist()
        wall = time.perf_counter() - t0
        if polish:
            x, z, y = self.solution_polishing(p, c, x, z, y)
            res = torch.stack(self.eval_result(p, c, gamma_c, gamma_b, x, z, y)).tolist()
        results = {"objective": res[0], "r_norm": res[1], "s_norm": res[2],
                   "eps_primal": res[3], "eps_dual": res[4], "iters": k,
                   "wall_s_incl_first_compile": wall}
        x_out = x * p.d / gamma_b
        return x_out, results

    def solution_polishing(self, p: LPProblem, c, x, z, y, delta: float = 1e-6,
                           refine_steps: int = 2):
        """Active-set KKT polishing with iterative refinement. Runs on the
        host in scipy sparse float64: a one-shot final step, not part of the
        hot loop."""
        import scipy.sparse.linalg as spla

        x_np, z_np, y_np = (t.detach().double().cpu().numpy() for t in (x, z, y))
        n = x_np.shape[0]
        Il = y_np < 0
        Iu = y_np > 0
        A_sp = p.A_host
        Al = A_sp[Il]
        Au = A_sp[Iu]
        nl, nu = Al.shape[0], Au.shape[0]
        if nl + nu == 0:
            return x, z, y
        Kp = sp.bmat([
            [delta * sp.eye(n), Al.T, Au.T],
            [Al, -delta * sp.eye(nl) if nl else None, None],
            [Au, None, -delta * sp.eye(nu) if nu else None],
        ], format="csc")
        Kp_gt = sp.bmat([
            [sp.csr_matrix((n, n)), Al.T, Au.T],
            [Al, sp.csr_matrix((nl, nl)), sp.csr_matrix((nl, nu))],
            [Au, sp.csr_matrix((nu, nl)), sp.csr_matrix((nu, nu))],
        ], format="csc")
        rhs = np.concatenate([-c.detach().double().cpu().numpy(), z_np[Il], z_np[Iu]])
        lu = spla.splu(Kp)
        t_hat = lu.solve(rhs)
        for _ in range(refine_steps):
            t_hat = t_hat + lu.solve(rhs - Kp_gt @ t_hat)
        x_new = t_hat[:n]
        yl = t_hat[n:n + nl]
        yu = t_hat[n + nl:]
        z_new = A_sp @ x_new
        y_new = y_np.copy()
        y_new[Il] = yl
        y_new[Iu] = yu
        put = lambda a: torch.as_tensor(a).to(device=x.device, dtype=self.dtype)
        return put(x_new), put(z_new), put(y_new)

    def solve_truncated(self, problem: LPProblem, params, iters: int = 10,
                        unroll_pcg_iters: int = 20):
        """Differentiable truncated solve for hyperparameter pretraining;
        returns the convergence-loss ingredients."""
        p = problem
        params = self._params(p, params)
        rho = params["rho"]
        sigma = torch.exp(params["sigma_log"])
        alpha = params["alpha"]
        c, lb, ub, gamma_c, gamma_b = self._prepare(p, params)
        carry = self._zero_carry(p)
        for _ in range(iters):
            carry = self._one_iter_unrolled(p, carry, rho, c, sigma, alpha, lb, ub,
                                            unroll_pcg_iters)
        x, z, y, _ = carry
        _, r_norm, s_norm, eps_p, eps_d = self.eval_result(
            p, c, gamma_c, gamma_b, x, z, y)
        return r_norm, s_norm, eps_p, eps_d

    def eval_result(self, p: LPProblem, c, gamma_c, gamma_b, x, z, y):
        A, AT = p.A, p.AT
        objval = torch.dot(c / p.d / gamma_c, x * p.d / gamma_b)
        Ax = A @ x
        ATy = AT @ y
        r_norm = _vec_norm((Ax - z) / p.e / gamma_b)
        s_norm = _vec_norm((c + ATy) / p.d / gamma_c)
        eps_p = self.abstol + self.reltol * torch.maximum(
            _vec_norm(Ax / p.e / gamma_b), _vec_norm(z / p.e / gamma_b))
        eps_d = self.abstol + self.reltol * torch.maximum(
            _vec_norm(ATy / p.d / gamma_c), _vec_norm(c / p.d / gamma_c))
        return objval, r_norm, s_norm, eps_p, eps_d


#: valid domains of the hyperparameters, enforced after every Adam step
PARAM_BOUNDS = {"rho": (1e-6, 1e6), "alpha": (0.1, 1.95), "sigma_log": (-30.0, 5.0),
                "gamma_c_mul": (1e-3, 1e3), "gamma_b_mul": (1e-3, 1e3)}


def pretrain_lp(solver: LPSolverADMM, problem: LPProblem, steps: int = 10,
                lr: float = 1e-2, verbose: bool = False):
    """``steps`` Adam steps on LPConvergenceLoss of a 10-iteration truncated
    solve. Returns (params, log): the best parameters seen (or the initial
    ones when every loss was non-finite), detached, and per step the loss at
    the parameters before the update and their gradients."""
    params = {k: v.to(problem.device).requires_grad_()
              for k, v in solver.init_params().items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss_fn = LPConvergenceLoss()
    best, log = (None, np.inf), []
    for i in range(steps):
        prev = {k: v.detach().clone() for k, v in params.items()}
        opt.zero_grad()
        loss = loss_fn(*solver.solve_truncated(problem, params, iters=10))
        loss.backward()
        # robustness: drop non-finite gradients (truncated unrolled solves
        # can blow up for bad hyperparameter regions)
        for v in params.values():
            v.grad = torch.where(torch.isfinite(v.grad), v.grad, torch.zeros_like(v.grad))
        log.append({"loss": float(loss.detach()), "grad": {k: float(v.grad) for k, v in params.items()}})
        opt.step()
        with torch.no_grad():  # keep hyperparameters in their valid domains
            for k, (lo, hi) in PARAM_BOUNDS.items():
                params[k].clamp_(lo, hi)
        v = log[-1]["loss"]  # the loss AT ``prev``: computed before the update
        if np.isfinite(v) and v < best[1]:
            best = (prev, v)
        if verbose:
            print(f"[lp-pretrain] step {i} loss {v:.4f} rho {float(params['rho']):.3e}")
    if best[0] is None:  # pretraining failed; fall back
        return {k: v.to(problem.device) for k, v in solver.init_params().items()}, log
    return best[0], log


def solve_lp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None,
             max_iters: int = 20000, pretrain_steps: int = 10,
             pretrain_lr: float = 1e-2, abstol: float = 1e-4,
             reltol: float = 1e-3, residual_balance: bool = True,
             verbose: bool = True, dtype=None, fused: bool = False,
             device="cuda", **kwargs):
    """End-to-end LP solve with hyperparameter pretraining: ``pretrain_steps``
    Adam steps on LPConvergenceLoss, then the full solve. ``fused=True`` runs
    the final solve with ``solve_fused`` (no history). ``dtype`` defaults to
    ``torch.get_default_dtype()``."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    problem = LPProblem(c, A_ub, b_ub, A_eq, b_eq, dtype=dtype, device=device)
    solver = LPSolverADMM(abstol=abstol, reltol=reltol, max_iters=max_iters,
                          dtype=dtype, verbose=verbose)
    params = None
    if pretrain_steps > 0:
        params, _ = pretrain_lp(solver, problem, pretrain_steps, pretrain_lr, verbose)

    if fused:
        x, results = solver.solve_fused(problem, params, max_iters=max_iters,
                                        residual_balance=residual_balance)
        return x, {}, results
    x, history, results = solver.solve(problem, params, max_iters=max_iters,
                                       residual_balance=residual_balance)
    return x, history, results

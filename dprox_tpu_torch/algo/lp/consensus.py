"""Scenario consensus ADMM for two-stage stochastic LPs.

Counterpart of dprox_tpu/algo/lp/consensus.py. The problem

    min_z  sum_s p_s [ c' x_s ]   s.t.  A_ub x_s <= b_ub,s
                                        A_eq x_s  = b_eq,s,  x_s >= 0
                                        x_s[shared_idx] = z   (nonanticipativity)

is solved by progressive hedging (consensus ADMM on the shared
first-stage block): each scenario solves an LP + quadratic
nonanticipativity penalty, a QP handled by the same OSQP-style splitting
as :class:`LPSolverADMM` with a diagonal quadratic term, and the
consensus variable is the probability-weighted mean of the scenario
first-stage iterates (``probs=None`` means equiprobable scenarios).

Stopping rule: the consensus (nonanticipativity) residual must reach
``tol`` and the worst scenario-subproblem primal infeasibility must
reach ``10*tol``; the looser factor because the inner OSQP split only
enforces Ax in [lb, ub] asymptotically and r_p trails r_na by about an
order of magnitude along the whole trajectory.

The constraint matrix is shared across scenarios (only the right-hand
sides vary), so equilibration runs once and every matvec is a
multi-right-hand-side apply ``A @ X`` with X (n, S): a batched tile
product (``BSRMat.matmat``) instead of S separate matvecs. Scenario state
has a leading batch axis, and the inner PCG is batched over it (its dot
products are the ``bdot`` kernel).

With a ``mesh`` (``parallel.create_mesh``) the scenarios are sharded over
the mesh axis: each rank iterates on its S/n scenarios, the inner
iterations and the PCG are rank-local, and the only collective of an
outer iteration is the consensus mean (a SUM all-reduce of the local
means, divided by n); each chunk's diagnostics add a SUM all-reduce (the
objective) and two MAX all-reduces (the residuals). Every rank reads the
same reduced values, so all ranks take the same control flow and return
the same z and objective.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ...linalg.solvers import cg_unrolled
from ...linalg.solvers import pcg as batched_pcg
from ...utils.misc import resolve_device
from .solvers import _clip, _sync
from .utils import ruiz_equilibration_sparse, scipy_to_device_op


class _Shard(NamedTuple):
    """A rank's share of the scenarios and the reductions over all of
    them: its bounds and normalized probabilities, the global mean over
    the scenario axis of a local [S_local, ...] tensor, and the global max
    of a local value."""

    lb: torch.Tensor
    ub: torch.Tensor
    pn: torch.Tensor
    gmean: Callable
    gmax: Callable
    gather: Callable  # local [S_local, ...] -> the whole [S, ...]


def _shard(p: "ScenarioLP", mesh, axis: str) -> _Shard:
    if mesh is None:
        return _Shard(p.lb, p.ub, p.pn, lambda v: torch.mean(v, dim=0), lambda v: v,
                      lambda v: v)
    from ...parallel.mesh import axis_size, check_device

    check_device(p.lb, mesh)
    group, n = mesh.get_group(axis), axis_size(mesh, axis)
    if p.S % n:
        raise ValueError(f"n_scenarios={p.S} must divide over the {n}-rank mesh axis {axis!r}")
    k = p.S // n
    rows = slice(mesh.get_local_rank(axis) * k, (mesh.get_local_rank(axis) + 1) * k)

    def gmean(v):
        m = torch.mean(v, dim=0)
        dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
        return m / n

    def gmax(v):
        v = v.clone()
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
        return v

    def gather(v):
        parts = [torch.empty_like(v) for _ in range(n)]
        dist.all_gather(parts, v.contiguous(), group=group)
        return torch.cat(parts)

    return _Shard(p.lb[rows], p.ub[rows], p.pn[rows], gmean, gmax, gather)


class ScenarioLP:
    """Preprocessed scenario family: one shared equilibrated constraint
    matrix, per-scenario bounds stacks.

    Parameters mirror :class:`LPProblem` (solvers.py) except ``b_eq_s``
    (and optionally ``b_ub_s``) carry a leading scenario axis.
    """

    def __init__(self, c, A_ub, b_ub, A_eq, b_eq_s, shared_idx,
                 b_ub_s=None, probs=None, dtype=torch.float64, device="cuda"):
        n = c.shape[0]
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        A_ub = sp.csr_matrix(A_ub) if A_ub is not None else sp.csr_matrix((0, n))
        A_eq = sp.csr_matrix(A_eq) if A_eq is not None else sp.csr_matrix((0, n))
        b_eq_s = np.atleast_2d(np.asarray(b_eq_s, np.float64))
        S = b_eq_s.shape[0]
        if b_ub_s is None:
            b_ub = np.zeros(0) if b_ub is None else np.asarray(b_ub).ravel()
            b_ub_s = np.tile(b_ub[None], (S, 1))
        else:
            b_ub_s = np.atleast_2d(np.asarray(b_ub_s, np.float64))
        self.S = S
        self.m_ub, self.m_eq, self.n = A_ub.shape[0], A_eq.shape[0], n

        A = sp.vstack([A_ub, A_eq, sp.eye(n)])
        # equilibrate against the mean-scenario rhs; gammas are not used
        # (the consensus penalty lives in true units, so cost/rhs scaling
        # would have to be folded into rho_ph; keep it at 1)
        d, e, _, _, A_bar, Acnorm = ruiz_equilibration_sparse(
            A, np.asarray(c, np.float64),
            np.concatenate([b_ub_s.mean(0), b_eq_s.mean(0), np.full(n, np.inf)]))
        put = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device=dev, dtype=dtype)
        self.A, self.AT = scipy_to_device_op(A_bar, dtype, device=dev)
        self.is_bsr = hasattr(self.A, "matmat")
        self.d = put(d)
        self.Acnorm = put(Acnorm)
        self.c = put(np.asarray(c).ravel())
        self.shared_idx = np.asarray(shared_idx, np.int32)
        self.E = torch.as_tensor(self.shared_idx.astype(np.int64)).to(dev)
        self.w = self.d[self.E]  # scaled->true factors, shared coords
        # scenario probabilities, normalized to mean 1 so a plain mean of
        # pn*v is the probability-weighted mean; None = equiprobable
        if probs is None:
            pn = np.ones(S)
        else:
            probs = np.asarray(probs, np.float64).ravel()
            if probs.shape[0] != S or (probs <= 0).any():
                raise ValueError(
                    f"probs must be {S} positive weights, got {probs.shape}")
            pn = S * probs / probs.sum()
        self.pn = put(pn)

        # per-scenario bounds in equilibrated row coordinates
        e = np.asarray(e)
        lb = np.concatenate([
            np.full((S, self.m_ub), -np.inf),
            b_eq_s * e[self.m_ub:self.m_ub + self.m_eq][None],
            np.zeros((S, n)),
        ], axis=1)
        ub = np.concatenate([
            b_ub_s * e[:self.m_ub][None],
            b_eq_s * e[self.m_ub:self.m_ub + self.m_eq][None],
            np.full((S, n), np.inf),
        ], axis=1)
        self.lb = put(lb)
        self.ub = put(ub)

    # batched applies: X (S, n) -> (S, m) and Y (S, m) -> (S, n)
    def apply_A(self, X):
        if self.is_bsr:
            return self.A.matmat(X.T).T
        return (self.A @ X.T).T

    def apply_AT(self, Y):
        if self.is_bsr:
            return self.AT.base.rmatmat(Y.T).T
        return (self.AT @ Y.T).T

    def shared_diag(self, values):
        """[n] vector that is ``values`` on the shared coordinates, else 0."""
        zeros = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        return zeros.index_put((self.E,), values)

    def linear_cost(self, u, z, rho_ph):
        """Per-scenario linear term of the subproblems: the scaled cost plus
        the consensus multipliers and penalty on the shared coordinates."""
        cbar = self.d * self.c
        q = torch.zeros((u.shape[0], self.n), dtype=self.dtype, device=self.device)
        return cbar[None] + q.index_add(1, self.E, self.w[None] * (u - rho_ph * z[None]))

    def zero_state(self, S: Optional[int] = None):
        """The solver's initial (x, zc, y, xt, u, z) for ``S`` scenarios
        (default: all of them)."""
        S = self.S if S is None else S
        n, m, k = self.n, self.lb.shape[1], self.E.shape[0]
        zeros = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return (zeros(S, n), zeros(S, m), zeros(S, m), zeros(S, n), zeros(S, k), zeros(k))


class ConsensusLPSolver:
    """Progressive-hedging consensus ADMM over scenario batches.

    ``rho``/``sigma``/``alpha`` parameterize the inner OSQP splitting
    exactly as :class:`LPSolverADMM`; ``rho_ph`` is the nonanticipativity
    penalty. All four live in a params dict so the convergence-loss
    pretraining pattern of ``solve_lp`` applies unchanged.
    """

    def __init__(self, rho: float = 1.0, sigma: float = 1e-6,
                 alpha: float = 1.6, rho_ph: float = 1.0,
                 inner_steps: int = 10, dtype=torch.float64,
                 verbose: bool = False):
        self.dtype = dtype
        self.inner_steps = inner_steps
        self.verbose = verbose
        self._defaults = dict(rho=rho, sigma=sigma, alpha=alpha,
                              rho_ph=rho_ph)

    def init_params(self):
        return {k: torch.tensor(v, dtype=self.dtype) for k, v in self._defaults.items()}

    def _params(self, p: ScenarioLP, params):
        params = params if params is not None else self.init_params()
        return {k: torch.as_tensor(v, dtype=self.dtype).to(p.device)
                for k, v in params.items()}

    @staticmethod
    def _inner_iter(p, carry, solve_x, q, rho, sigma, alpha, lb, ub):
        x, zc, y, xt = carry
        right = sigma * x - q + p.apply_AT(rho * zc - y)
        xt = solve_x(right, xt)
        zt = p.apply_A(xt)
        x = alpha * xt + (1 - alpha) * x
        zt = alpha * zt + (1 - alpha) * zc
        zc = _clip(zt + y / rho, lb, ub)
        y = y + rho * (zt - zc)
        return (x, zc, y, xt)

    def solve_truncated(self, p: ScenarioLP, params, outer_iters: int = 5,
                        inner_steps: int = 3, unroll_pcg_iters: int = 15):
        """Differentiable truncated run (fixed-iteration unrolled CG, no
        host control flow) for convergence-loss hyperparameter
        pretraining, the consensus counterpart of
        ``LPSolverADMM.solve_truncated``. Returns (r_na, r_p, obj)."""
        params = self._params(p, params)
        E, w = p.E, p.w
        rho, sigma, alpha, rho_ph = (params["rho"], params["sigma"],
                                     params["alpha"], params["rho_ph"])
        Pvec = p.shared_diag(rho_ph * w ** 2)

        def KtK(V):
            return p.apply_AT(rho * p.apply_A(V)) + (sigma + Pvec) * V

        solve_x = lambda right, xt: cg_unrolled(KtK, right, x0=xt, rtol=1e-12,
                                                max_iters=unroll_pcg_iters)
        x, zc, y, xt, u, z = p.zero_state()
        for _ in range(outer_iters):
            q = p.linear_cost(u, z, rho_ph)
            for _ in range(inner_steps):
                x, zc, y, xt = self._inner_iter(p, (x, zc, y, xt), solve_x, q, rho,
                                                sigma, alpha, p.lb, p.ub)
            xE = w[None] * x[:, E]
            z = torch.mean(p.pn[:, None] * xE, dim=0)
            u = u + rho_ph * (xE - z[None])
        xE = w[None] * x[:, E]
        r_na = torch.max(torch.abs(xE - z[None]))
        Ax = p.apply_A(x)
        r_p = torch.max(torch.abs(Ax - _clip(Ax, p.lb, p.ub)))
        obj = p.c @ (p.pn[:, None] * p.d[None] * x).mean(0)
        return r_na, r_p, obj

    def pretrain(self, p: ScenarioLP, steps: int = 10, lr: float = 2e-2,
                 outer_iters: int = 5, inner_steps: int = 3,
                 unroll_pcg_iters: int = 15):
        """Optimize (rho, sigma, alpha, rho_ph) by Adam on the truncated
        consensus convergence loss log(r_na) + log(r_p). Positivity via
        log-space; alpha constrained to (0, 2) by a scaled sigmoid."""
        p0 = self._params(p, None)
        logits = {
            "rho": torch.log(p0["rho"]),
            "sigma": torch.log(p0["sigma"]),
            "rho_ph": torch.log(p0["rho_ph"]),
            "alpha": torch.log(p0["alpha"] / (2.0 - p0["alpha"])),
        }
        logits = {k: v.detach().requires_grad_() for k, v in logits.items()}

        def to_params(lg):
            return {"rho": torch.exp(lg["rho"]), "sigma": torch.exp(lg["sigma"]),
                    "rho_ph": torch.exp(lg["rho_ph"]),
                    "alpha": 2.0 * torch.sigmoid(lg["alpha"])}

        opt = torch.optim.Adam(list(logits.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        best, best_val = {k: v.detach().clone() for k, v in logits.items()}, np.inf
        for i in range(steps + 1):
            prev = {k: v.detach().clone() for k, v in logits.items()}
            opt.zero_grad()
            r_na, r_p, _ = self.solve_truncated(
                p, to_params(logits), outer_iters=outer_iters,
                inner_steps=inner_steps, unroll_pcg_iters=unroll_pcg_iters)
            loss = (torch.log(torch.clamp(r_na, min=1e-12))
                    + torch.log(torch.clamp(r_p, min=1e-12)))
            loss.backward()
            opt.step()
            # val is the loss AT ``prev`` (computed before the update)
            val = float(loss.detach())
            if np.isfinite(val) and val < best_val:
                best, best_val = prev, val
            if self.verbose:
                print(f"pretrain step {i} loss={val:.4f}")
        with torch.no_grad():
            return {k: v.to(self.dtype) for k, v in to_params(best).items()}

    def _build(self, p: ScenarioLP, params, pcg_iters: int, pcg_rtol: float, sh: _Shard):
        """Shared iteration machinery for ``solve`` (host control) and
        ``solve_fused`` (device control) on the scenarios of ``sh``:
        returns ``chunk_body``."""
        dt = self.dtype
        # same dtype-aware floor as LPSolverADMM: an unreachable inner
        # tolerance just burns the PCG iteration cap in roundoff noise
        pcg_rtol = max(pcg_rtol, 50 * torch.finfo(dt).eps)
        E, w = p.E, p.w
        c_true = p.c
        local_mask = torch.ones(p.n, dtype=torch.bool, device=p.device)
        local_mask[E] = False
        rho, sigma, alpha = params["rho"], params["sigma"], params["alpha"]

        def chunk_body(carry, rho_ph, steps: int):
            # rho_ph is a 0-d tensor, so residual balancing never leaves
            # the device in solve_fused
            x, zc, y, xt, u, z = carry
            Pvec = p.shared_diag(rho_ph * w ** 2)
            Minv_diag = 1.0 / (sigma + Pvec + rho * p.Acnorm ** 2)
            # probability-weighted mean: pn is normalized to mean 1, hence
            # mean(pn*v) = sum_s p_s v_s
            wmean = lambda v: sh.gmean(sh.pn[:, None] * v)

            def KtK(V):
                return p.apply_AT(rho * p.apply_A(V)) + (sigma + Pvec) * V

            solve_x = lambda right, xt: batched_pcg(
                KtK, right, Minv=lambda r: r * Minv_diag, x0=xt, rtol=pcg_rtol,
                max_iters=pcg_iters)
            z_in = z
            for _ in range(steps):
                q = p.linear_cost(u, z, rho_ph)
                for _ in range(self.inner_steps):
                    x, zc, y, xt = self._inner_iter(p, (x, zc, y, xt), solve_x, q, rho,
                                                    sigma, alpha, sh.lb, sh.ub)
                xE = w[None] * x[:, E]  # true units
                z = wmean(xE)
                u = u + rho_ph * (xE - z[None])
            xE = w[None] * x[:, E]
            r_na = sh.gmax(torch.max(torch.abs(xE - z[None])))
            # consensus dual-residual proxy: mean per-iteration z movement
            dz = torch.max(torch.abs(z - z_in)) / steps
            x_true = p.d[None] * x
            obj_local = x_true[:, local_mask] @ c_true[local_mask]
            obj = c_true[E] @ z + wmean(obj_local[:, None])[0]
            # worst primal infeasibility of the scenario subproblems
            Ax = p.apply_A(x)
            r_p = sh.gmax(torch.max(torch.abs(Ax - _clip(Ax, sh.lb, sh.ub))))
            return (x, zc, y, xt, u, z), (r_na, obj, r_p, dz)

        return chunk_body

    @torch.no_grad()
    def solve(self, p: ScenarioLP, params: Optional[dict] = None,
              mesh=None, axis: str = "scenario",
              max_outer: int = 400, eval_freq: int = 20, tol: float = 1e-3,
              pcg_iters: int = 200, pcg_rtol: float = 1e-9,
              adapt_rho_ph: bool = True):
        """Returns (z, x_s, history, results).

        z: consensus first-stage solution (true units, shape (k,));
        x_s: per-scenario full solutions (S, n), both numpy; results: dict
        with the extensive-form objective and residuals at exit. With a
        ``mesh`` the scenarios are sharded over its ``axis`` (S must divide
        its size) and every rank returns the whole result.
        """
        params = self._params(p, params)
        dt = self.dtype
        sh = _shard(p, mesh, axis)
        chunk_body = self._build(p, params, pcg_iters, pcg_rtol, sh)
        history = defaultdict(list)
        carry = p.zero_state(sh.lb.shape[0])

        k = 0
        r_na = obj = r_p = None
        rho_ph = float(params["rho_ph"])
        rho_ph0 = rho_ph
        while k < max_outer:
            steps = min(eval_freq, max_outer - k)
            t0 = time.perf_counter()
            carry, out = chunk_body(
                carry, torch.tensor(rho_ph, dtype=dt, device=p.device), steps)
            k += steps
            r_na, obj, r_p, dz = torch.stack(out).tolist()  # one host fetch
            history["t_chunk"].append(time.perf_counter() - t0)
            history["r_nonanticipativity"].append(r_na)
            history["objective"].append(obj)
            history["r_primal"].append(r_p)
            history["rho_ph"].append(rho_ph)
            if self.verbose:
                print(f"outer={k} obj={obj:.6e} r_na={r_na:.3e} r_p={r_p:.3e} "
                      f"rho_ph={rho_ph:.2e}")
            if r_na < tol and r_p < tol * 10:
                break
            if adapt_rho_ph:
                # residual balancing on the consensus split: primal =
                # scenario disagreement, dual proxy = rho_ph * z movement
                # per outer iteration (same x2 policy as the single-LP
                # solver's residual balance)
                s_norm = rho_ph * dz
                if r_na > 10 * s_norm:
                    rho_ph = min(rho_ph * 2, rho_ph0 * 1e6)
                elif s_norm > 10 * r_na:
                    rho_ph = max(rho_ph / 2, rho_ph0 * 1e-4)

        x, zc, y, xt, u, z = carry
        x_true = sh.gather(p.d[None] * x).cpu().numpy()
        results = {"objective": obj, "r_nonanticipativity": r_na,
                   "r_primal": r_p, "outer_iters": k,
                   "rho_ph_final": rho_ph}
        return z.cpu().numpy(), x_true, history, results

    @torch.no_grad()
    def solve_fused(self, p: ScenarioLP, params: Optional[dict] = None,
                    mesh=None, axis: str = "scenario",
                    max_outer: int = 400, eval_freq: int = 20,
                    tol: float = 1e-3, pcg_iters: int = 200,
                    pcg_rtol: float = 1e-9, adapt_rho_ph: bool = True):
        """The consensus solve with its control on the device (counterpart
        of ``LPSolverADMM.solve_fused``): the convergence test and the
        rho_ph residual balancing are tensor operations, and the loop reads
        the host once per chunk. Returns (z, x_s, results); a ``mesh`` as in
        ``solve``."""
        params = self._params(p, params)
        sh = _shard(p, mesh, axis)
        chunk_body = self._build(p, params, pcg_iters, pcg_rtol, sh)
        rho_ph0 = params["rho_ph"]
        rho_ph = rho_ph0
        carry = p.zero_state(sh.lb.shape[0])
        res = torch.full((4,), float("inf"), dtype=self.dtype, device=p.device)
        k, done = 0, False
        while k < max_outer and not done:
            # clamp the last chunk so max_outer is never overrun when
            # eval_freq does not divide it
            steps = min(eval_freq, max_outer - k)
            carry, (r_na, obj, r_p, dz) = chunk_body(carry, rho_ph, steps)
            k += steps
            done_t = (r_na < tol) & (r_p < tol * 10)
            if adapt_rho_ph:
                s_norm = rho_ph * dz
                up = r_na > 10 * s_norm
                dn = s_norm > 10 * r_na
                rho_ph = torch.where(
                    ~done_t & up, torch.minimum(rho_ph * 2, rho_ph0 * 1e6),
                    torch.where(~done_t & dn,
                                torch.maximum(rho_ph / 2, rho_ph0 * 1e-4), rho_ph))
            res = torch.stack([r_na, obj, r_p, rho_ph])
            done = bool(done_t)  # the chunk's one host read
        x, zc, y, xt, u, z = carry
        res = res.tolist()
        _sync(x)
        x_true = sh.gather(p.d[None] * x).cpu().numpy()
        results = {"objective": res[1], "r_nonanticipativity": res[0],
                   "r_primal": res[2], "outer_iters": k, "rho_ph_final": res[3]}
        return z.cpu().numpy(), x_true, results


def solve_consensus_lp(c, A_ub, b_ub, A_eq, b_eq_s, shared_idx,
                       mesh=None, dtype=None, pretrain_steps: int = 0,
                       fused: bool = False, probs=None, device="cuda", **kwargs):
    """One-call scenario-consensus solve (counterpart of ``solve_lp``).

    ``probs``: optional per-scenario probabilities (consensus and the
    reported objective are probability-weighted; None = equiprobable).
    ``pretrain_steps > 0`` first tunes (rho, sigma, alpha, rho_ph) by
    Adam on the truncated-run convergence loss, then runs the full solve
    with the learned hyperparameters. ``fused=True`` runs that solve with
    its control on the device (no residual history). ``dtype`` defaults to
    ``torch.get_default_dtype()``. ``mesh``: shard the scenarios over a
    mesh axis (``axis=``, default "scenario"); the pretraining runs on
    every rank alike, on the whole problem."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    solver_kw = {k: kwargs.pop(k) for k in
                 ("rho", "sigma", "alpha", "rho_ph", "inner_steps", "verbose")
                 if k in kwargs}
    p = ScenarioLP(c, A_ub, b_ub, A_eq, b_eq_s, shared_idx, probs=probs,
                   dtype=dtype, device=device)
    solver = ConsensusLPSolver(dtype=dtype, **solver_kw)
    params = solver.pretrain(p, steps=pretrain_steps) if pretrain_steps \
        else None
    if fused:
        z, x_s, results = solver.solve_fused(p, params=params, mesh=mesh, **kwargs)
        return z, x_s, {}, results
    return solver.solve(p, params=params, mesh=mesh, **kwargs)

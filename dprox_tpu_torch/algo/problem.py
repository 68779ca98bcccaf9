"""Problem entry object (counterpart of dprox_tpu/algo/problem.py).

``Problem(c @ x, [A @ x == b, A @ x <= b])`` dispatches onto the LP path
(``algo.lp.solve_lp``); every other objective is rewritten by the absorb
pass and compiled to a proximal solver.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..linalg import LinearSolveConfig
from ..linop.constraints import equality, less, matmul
from ..proxfn.base import ProxFn
from .primitives import compile, optimize


class Problem:
    def __init__(self, prox_fns=None, constraints=None, absorb: bool = True,
                 merge: bool = False, try_diagonalize: bool = True,
                 try_freq_diagonalize: bool = True,
                 linear_solve_config: Optional[LinearSolveConfig] = None):
        if isinstance(prox_fns, matmul):
            self._lp = LPProblem(prox_fns, constraints or [])
            self.prox_fns = None
            return
        self._lp = None
        if isinstance(prox_fns, ProxFn):
            prox_fns = [prox_fns]
        self.raw_prox_fns = list(prox_fns)
        self.absorb = absorb
        self.try_diagonalize = try_diagonalize
        self.try_freq_diagonalize = try_freq_diagonalize
        self.linear_solve_config = linear_solve_config or LinearSolveConfig()
        self.prox_fns = optimize(self.raw_prox_fns, absorb=absorb)

    @property
    def objective(self):
        return self.prox_fns

    def solve(self, method: str = "admm", device="cuda", **kwargs):
        """Solve on ``device``; the keywords go to the solver's ``solve``
        (or to ``solve_lp`` for an LP)."""
        if self._lp is not None:
            return self._lp.solve(device=device, **kwargs)
        if method == "pgd":
            solver = compile(self.prox_fns, method=method, device=device)
        else:
            solver = compile(self.prox_fns, method=method, device=device,
                             try_diagonalize=self.try_diagonalize,
                             try_freq_diagonalize=self.try_freq_diagonalize,
                             linear_solve_config=self.linear_solve_config)
        return solver.solve(**kwargs)

    def optimize(self):
        self.prox_fns = optimize(self.raw_prox_fns, absorb=self.absorb)
        return self


class LPProblem:
    """An LP given as ``c @ x`` and ``A @ x <= b`` / ``A @ x == b``
    constraints; ``solve`` pretrains the learnable ADMM hyperparameters on
    a convergence loss, then solves (``algo.lp.solve_lp``)."""

    def __init__(self, objective: matmul, constraints: List):
        self.c = objective.A
        self.x = objective.x
        self.A_ub, self.b_ub, self.A_eq, self.b_eq = [], [], [], []
        for con in constraints:
            if isinstance(con, less):
                self.A_ub.append(con.A)
                self.b_ub.append(con.b)
            elif isinstance(con, equality):
                self.A_eq.append(con.A)
                self.b_eq.append(con.b)

    def solve(self, max_iters: int = 20000, pretrain_steps: int = 10, **kwargs):
        import scipy.sparse as sp

        from .lp import solve_lp

        def stack(As, bs):
            if not As:
                return None, None
            return (sp.vstack([sp.csr_matrix(a) for a in As]),
                    np.concatenate([np.asarray(b).ravel() for b in bs]))

        A_ub, b_ub = stack(self.A_ub, self.b_ub)
        A_eq, b_eq = stack(self.A_eq, self.b_eq)
        return solve_lp(np.asarray(self.c).ravel(), A_ub, b_ub, A_eq, b_eq,
                        max_iters=max_iters, pretrain_steps=pretrain_steps, **kwargs)

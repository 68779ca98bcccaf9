"""Algorithm unrolling specialization.

Counterpart of dprox_tpu/algo/special/unroll.py. ``share=True`` pins
(max_iter, schedules) onto ``solve``; ``share=False`` learns one rho and
one lam per iteration (and, with ``deep_prior(unroll_step=...)``, one set
of denoiser weights per iteration). The learnable schedules travel in the
``params`` dict as ``unroll_rhos`` / ``unroll_lams``, so a loss on the
solve's output differentiates to them.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

from ..base import Algorithm


def build_unrolled_solver(solver: Algorithm, share: bool = True, **kwargs):
    if share:
        solver.solve = partial(solver.solve, **kwargs)
        return solver
    return UnrolledSolver(solver, **kwargs)


class UnrolledSolver:
    def __init__(self, solver: Algorithm, max_iter: int = 10, learned_params: bool = False,
                 rhos=None, lams=None, **kwargs):
        self.solver = solver
        self.max_iter = max_iter
        self.learned_params = learned_params
        self._rhos0, self._lams0 = solver.defaults(rhos, lams, max_iter)

    def init_params(self):
        """``unroll_rhos`` [max_iter] and ``unroll_lams`` (one [max_iter]
        tensor per psi fn), new tensors on the solver's device."""
        if not self.learned_params:
            return {}
        return {"unroll_rhos": self._rhos0.clone(),
                "unroll_lams": tuple(l.clone() for l in self._lams0)}

    def solve(self, x0=None, params: Optional[dict] = None, **kwargs):
        params = dict(params) if params else {}
        rhos = params.get("unroll_rhos", self._rhos0)
        lams = params.get("unroll_lams", self._lams0)
        return self.solver.solve(x0=x0, rhos=rhos, lams=list(lams), max_iter=self.max_iter,
                                 params=params, **kwargs)

    def __getattr__(self, name):
        return getattr(self.solver, name)

"""Consensus-form ADMM: every proxfn is an independent block.

Counterpart of dprox_tpu/algo/cadmm.py (Boyd et al. §7.1, scaled duals).
Every f_i gets its own full-variable copy x_i with the coupling x_i = z:

    x_i <- argmin f_i(K_i x) + rho/2 ||x - (z - u_i)||^2
    z   <- mean_i (x_i + u_i)
    u_i <- u_i + x_i - z

Quadratic blocks solve in closed form with one ``least_squares`` each (a
deconvolution block takes the frequency route through ``freq_divide``,
CG where no transform diagonalizes it); identity-linop blocks are one
prox or denoiser call.
"""
from __future__ import annotations

from typing import List

import torch

from ..linalg import LinearSolveConfig
from ..linop.base import Variable
from ..proxfn.base import ProxFn
from ..proxfn.sum_squares import least_squares, sum_squares, weighted_sum_squares
from .base import Algorithm, IterAux


class ConsensusADMM(Algorithm):
    """Global-variable consensus ADMM over proxfn blocks."""

    @classmethod
    def partition(cls, prox_fns: List[ProxFn]):
        return list(prox_fns), []  # every fn is a consensus block

    def __init__(self, psi_fns, omega_fns, try_diagonalize=True,
                 try_freq_diagonalize=True,
                 linear_solve_config: LinearSolveConfig = None, device="cuda"):
        super().__init__(psi_fns, omega_fns, device=device)
        cfg = linear_solve_config or LinearSolveConfig()
        self.block_solvers = []
        for fn in self.psi_fns:
            if isinstance(fn, (sum_squares, weighted_sum_squares)):
                self.block_solvers.append(least_squares(
                    [fn], [], try_diagonalize, try_freq_diagonalize,
                    linear_solve_config=cfg))
            elif isinstance(fn.linop, Variable):
                self.block_solvers.append(None)  # a direct prox block
            else:
                raise ValueError(
                    f"consensus ADMM needs quadratic or identity-linop blocks; "
                    f"{type(fn).__name__} has linop {type(fn.linop).__name__} — "
                    f"compile with method='admm' instead")

    def initialize(self, x0, params):
        return (x0, tuple(x0 for _ in self.psi_fns),
                tuple(torch.zeros_like(x0) for _ in self.psi_fns))

    def prepare_aux(self, x0, params) -> IterAux:
        var_shapes = self._var_shapes(x0)
        offsets = tuple(fn.offset(var_shapes, params) for fn in self.psi_fns)
        lsqs = tuple(ls.prepare(var_shapes, params, ref_shape=tuple(x0.shape))
                     if ls is not None else None for ls in self.block_solvers)
        return IterAux(offsets=offsets, lsq=lsqs)

    def _iter(self, state, rho, lam, step, params, aux):
        z, xs, us = state
        var_shapes = self._var_shapes(z)
        xs_new = []
        for i, fn in enumerate(self.psi_fns):
            vi = z - us[i]
            ls = self.block_solvers[i]
            if ls is not None:
                xi = ls.solve([], rho, v=vi, params=params, var_shapes=var_shapes,
                              prepared=aux.lsq[i])
            else:
                xi = fn.prox(vi, lam[i], params=params, step=step, offset=aux.offsets[i])
            xs_new.append(xi.to(z.dtype))
        n = len(xs_new)
        z_new = sum(xs_new[i] + us[i] for i in range(n)) / n
        us_new = tuple(us[i] + xs_new[i] - z_new for i in range(n))
        return (z_new, tuple(xs_new), us_new)

    def residuals(self, prev_state, state, rho, params):
        """r_p = ||x_i - z|| (block disagreement), r_d = rho n ||z - z_prev||
        (Boyd §7.1.1), both relative."""
        z, xs, us = state
        z_prev = prev_state[0]

        def nrm(ts):
            return torch.sqrt(sum(torch.sum(torch.abs(t) ** 2) for t in ts))

        r_p = nrm([x - z for x in xs])
        p_scale = torch.maximum(nrm(xs), nrm([z] * len(xs))) + 1e-12
        r_d = rho * len(xs) * nrm([z - z_prev])
        d_scale = rho * nrm(us) + 1e-12
        return {"r_primal": r_p / p_scale, "r_dual": r_d / d_scale}

    @property
    def nparams(self):
        return len(self.psi_fns) + 1

    @property
    def state_split(self):
        return [1, [len(self.psi_fns)], [len(self.psi_fns)]]

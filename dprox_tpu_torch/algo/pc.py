"""Pock-Chambolle primal-dual hybrid gradient.

Counterpart of dprox_tpu/algo/pc.py: textbook PDHG with the exact Moreau
identity,

    w_i   = z_i + sigma_i * K_i xbar
    z_i   = w_i - sigma_i * prox_{f_i / sigma_i}(w_i / sigma_i)
    x'    = prox_{g / rho}(x - (1/rho) * sum_i K_i^T z_i)   [least-squares]
    xbar  = 2 x' - x

with sigma_i = lam[i] (dual step) and rho = 1/tau (primal step);
convergence needs tau * sigma * ||K||^2 <= 1. The x-update solves only
the omega (data) terms, ``least_squares.solve([], rho, v=v)``, on the
frequency route where the data operator is circulant, or, where the data
term is a fused fast prox (``ext_sum_squares``), its closed-form solve of
``v``.
"""
from __future__ import annotations

import torch

from ..linalg import LinearSolveConfig
from ..proxfn.sum_squares import ext_sum_squares, least_squares
from ..utils.misc import expand_to_bchw
from .admm import ADMM


class PockChambolle(ADMM):
    def __init__(self, psi_fns, omega_fns, try_diagonalize=True,
                 try_freq_diagonalize=True, linear_solve_config=None, device="cuda"):
        super().__init__(psi_fns, omega_fns, try_diagonalize, try_freq_diagonalize,
                         linear_solve_config, device=device)
        # the x-update resolvent involves only the omega terms:
        # (sum K_q^T K_q + rho I)^-1 (sum K_q^T b_q + rho v)
        if not isinstance(self.least_square, ext_sum_squares):
            self.least_square = least_squares(
                self.omega_fns, [], try_diagonalize, try_freq_diagonalize,
                linear_solve_config=linear_solve_config or LinearSolveConfig())

    def initialize(self, x0, params, v=None):
        z = tuple(torch.zeros_like(e) for e in self.K_forward(x0, params))
        return (x0, z, x0)

    def residuals(self, prev_state, state, rho, params):
        return None  # the PDHG state does not fit the consensus-residual template

    @property
    def state_split(self):
        return [1, [len(self.psi_fns)], 1]

    def _iter(self, state, rho, lam, step, params, aux):
        x, z, xbar = state
        Kxbar = self.K_forward(xbar, params)
        z_new = []
        for i, fn in enumerate(self.psi_fns):
            sigma = expand_to_bchw(torch.as_tensor(lam[i], device=x.device))
            w = z[i] + sigma * Kxbar[i]
            z_new.append(w - sigma * fn.prox(w / sigma, 1.0 / lam[i], params=params,
                                             step=step, offset=aux.offsets[i]))
        Ktz = 0.0
        for i, fn in enumerate(self.psi_fns):
            Ktz = Ktz + fn.dag_adjoint(z_new[i], params)
        tau = 1.0 / expand_to_bchw(torch.as_tensor(rho, device=x.device))
        v = x - tau * Ktz
        if isinstance(self.least_square, ext_sum_squares):
            x_next = self.least_square.solve([v], rho, params=params)
        elif self.omega_fns:
            x_next = self.least_square.solve([], rho, v=v, params=params,
                                             var_shapes=self._var_shapes(x),
                                             prepared=aux.lsq)
        else:
            x_next = v
        return (x_next, tuple(z_new), x_next + x_next - x)

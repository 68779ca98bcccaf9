"""Half-quadratic splitting (counterpart of dprox_tpu/algo/hqs.py).

State (x, z_tuple): the x-update takes z as its consensus targets, then
z_i = prox_i(K_i x). No dual variables, so no residuals.
"""
from __future__ import annotations

from .admm import ADMM


class HQS(ADMM):
    def initialize(self, x0, params, v=None):
        return (x0, tuple(self.K_forward(x0, params)))

    def _iter(self, state, rho, lam, step, params, aux):
        x, z = state
        x = self.least_square.solve(list(z), rho, params=params,
                                    var_shapes=self._var_shapes(x),
                                    prepared=aux.lsq, warm=x)
        Kx = self.K_forward(x, params)
        z_new = tuple(fn.prox(Kx[i], lam[i], params=params, step=step,
                              offset=aux.offsets[i]).to(Kx[i].dtype)
                      for i, fn in enumerate(self.psi_fns))
        return (x, z_new)

    def residuals(self, prev_state, state, rho, params):
        return None

    @property
    def state_split(self):
        return [1, [len(self.psi_fns)]]

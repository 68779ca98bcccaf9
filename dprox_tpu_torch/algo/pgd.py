"""Proximal gradient descent (counterpart of dprox_tpu/algo/pgd.py).

Exactly two proxfns: one differentiable (it has ``grad``) as omega, the
other as psi; x <- prox_psi(x - rho * grad_omega(x)).
"""
from __future__ import annotations

from typing import List

import torch

from ..proxfn.base import ProxFn
from ..utils.misc import expand_to_bchw
from .base import Algorithm


class ProximalGradientDescent(Algorithm):
    @classmethod
    def partition(cls, prox_fns: List[ProxFn]):
        if len(prox_fns) != 2:
            raise ValueError("PGD supports exactly two proximal functions")
        omega_fns = [fn for fn in prox_fns if hasattr(fn, "grad")]
        psi_fns = [fn for fn in prox_fns if fn not in omega_fns]
        if not omega_fns:
            raise ValueError("PGD requires one differentiable function")
        if not psi_fns:
            # both differentiable: the first is omega, the second is proxed
            omega_fns, psi_fns = [prox_fns[0]], [prox_fns[1]]
        return psi_fns, omega_fns

    def __init__(self, psi_fns, omega_fns, device="cuda"):
        super().__init__(psi_fns, omega_fns, device=device)
        self.diff_fn = self.omega_fns[0]
        self.prox_fn = self.psi_fns[0]

    def initialize(self, x0, params):
        return (x0,)

    def _iter(self, state, rho, lam, step, params, aux):
        (x,) = state
        rho = expand_to_bchw(torch.as_tensor(rho, device=x.device))
        v = x - rho * self.diff_fn.grad(x, params)
        return (self.prox_fn.prox(v, lam[0], params=params, step=step,
                                  offset=aux.offsets[0]),)

    @property
    def state_split(self):
        return [1]

    @property
    def nparams(self):
        return len(self.psi_fns) + 1

"""ADMM, linearized ADMM and prox-first ADMM as eager iteration steps.

Counterpart of dprox_tpu/algo/admm.py (``ADMM``, ``LinearizedADMM``,
``ADMM_vxu``). Partition rule: plain ``sum_squares`` (and at most one
``ext_sum_squares``) go to the omega (data) set solved in the x-update;
everything else becomes a psi block with consensus variables (v_i, u_i).
State = (x, v_tuple, u_tuple), complex64 where the x-update is a fused
k-space solve (``complex_state``, CS-MRI); prox outputs are cast back to
the state's dtype. In ``ADMM`` the (v_i, u_i) update of a plain ``nonneg``
or ``norm1`` block on a real state runs as one ``fused_admm_update``
kernel, which computes exactly what the generic prox + dual update
computes (on a complex state such a block raises: torch orders no complex
numbers); the two variants override ``_iter`` and take the generic route,
as in the JAX package.

With ``spatial_mesh`` the x-update runs sharded over the mesh
(``least_squares(spatial_mesh=)``) and the state is carried as DTensors
sharded in H: the loop between the x-update and the proxes is pointwise,
and the kernel of a fused block runs on each rank's rows.
"""
from __future__ import annotations

from typing import List

import torch

from ..linalg import LinearSolveConfig
from ..ops.kernels import fused_admm_update
from ..proxfn.base import ProxFn
from ..proxfn.simple import nonneg, norm1
from ..proxfn.sum_squares import ext_sum_squares, sum_squares
from ..utils.misc import is_dtensor
from .base import Algorithm
from .invert import get_least_square_solver


class ADMM(Algorithm):
    @classmethod
    def partition(cls, prox_fns: List[ProxFn]):
        omega_fns, have_ext = [], False
        for fn in prox_fns:
            if not have_ext and isinstance(fn, ext_sum_squares):
                omega_fns.append(fn)
                have_ext = True
            elif type(fn) is sum_squares:
                omega_fns.append(fn)
        psi_fns = [fn for fn in prox_fns if fn not in omega_fns]
        return psi_fns, omega_fns

    def __init__(self, psi_fns, omega_fns, try_diagonalize=True,
                 try_freq_diagonalize=True,
                 linear_solve_config: LinearSolveConfig = None, device="cuda",
                 spatial_mesh=None, spatial_axis: str = "space", spatial_batch_axis=None):
        super().__init__(psi_fns, omega_fns, device=device)
        self.least_square = get_least_square_solver(
            self.psi_fns, self.omega_fns, try_diagonalize, try_freq_diagonalize,
            linear_solve_config or LinearSolveConfig(), spatial_mesh=spatial_mesh,
            spatial_axis=spatial_axis, spatial_batch_axis=spatial_batch_axis)

    def _prepare_x0(self, x0):
        """With a sharded x-update, x0 (a DTensor, or a global value that each
        rank slices) is carried sharded as the x-update shards its output."""
        x0 = super()._prepare_x0(x0)
        ls = self.least_square
        if getattr(ls, "spatial_mesh", None) is None:
            return x0
        from ..parallel.mesh import from_local

        return from_local(ls._rows(x0), ls.spatial_mesh, ls._row_dims)

    def initialize(self, x0, params, v=None):
        if getattr(self.least_square, "complex_state", False):
            x0 = x0.to(torch.complex64)
        if v is None:
            v = tuple(self.K_forward(x0, params))
        u = tuple(torch.zeros_like(e) for e in v)
        return (x0, v, u)

    def _iter(self, state, rho, lam, step, params, aux):
        x, v, u = state
        b = [v[i] - u[i] for i in range(len(self.psi_fns))]
        x = self.least_square.solve(b, rho, params=params,
                                    var_shapes=self._var_shapes(x),
                                    prepared=aux.lsq, warm=x)
        Kx = self.K_forward(x, params)
        v_new, u_new = [], []
        for i, fn in enumerate(self.psi_fns):
            if Kx[i].is_complex() and type(fn) in (nonneg, norm1):
                raise NotImplementedError(
                    f"{type(fn).__name__} on a complex solver state: torch defines no order "
                    "on complex numbers (the JAX package's jnp.maximum orders them "
                    "lexicographically), so neither the fused_admm_update kernel nor a "
                    "generic prox computes it")
            kind = self._fused_kind(fn, aux.offsets[i])
            if kind is None:
                vi = fn.prox(Kx[i] + u[i], lam[i], params=params, step=step,
                             offset=aux.offsets[i]).to(Kx[i].dtype)
                ui = u[i] + Kx[i] - vi
            else:  # alpha * f scales lam, as in ProxFn.prox; nonneg reads no lam
                lam_i = lam[i] if kind == "nonneg" or fn.alpha == 1.0 else lam[i] * fn.alpha
                update = lambda k, uu: fused_admm_update(k.contiguous(), uu.contiguous(),  # noqa: E731
                                                         lam_i, kind)
                if is_dtensor(Kx[i]):  # the kernel runs on this rank's blocks
                    from ..parallel.mesh import map_local

                    vi, ui = map_local(update, Kx[i], u[i])
                else:
                    vi, ui = update(Kx[i], u[i])
            v_new.append(vi)
            u_new.append(ui)
        return (x, tuple(v_new), tuple(u_new))

    @staticmethod
    def _fused_kind(fn, offset):
        """``fused_admm_update``'s kind for a psi fn whose (v, u) update it
        computes exactly: an untranslated ``nonneg`` or ``norm1`` with
        beta == 1. None for every other fn (generic prox + dual update)."""
        if offset is not None or fn.beta != 1.0:
            return None
        return {nonneg: "nonneg", norm1: "soft"}.get(type(fn))

    def residuals(self, prev_state, state, rho, params):
        """Scaled-ADMM residuals (Boyd et al. §3.3), relative:
        r_p = ||Kx - v|| / max(||Kx||, ||v||),
        r_d = ||K^T (v - v_prev)|| / max(||K^T u||, ||K^T v||)."""
        x, v, u = state
        v_prev = prev_state[1]

        def nrm(ts):
            return torch.sqrt(sum(torch.sum(torch.abs(t) ** 2) for t in ts))

        Kx = self.K_forward(x, params)
        n = len(self.psi_fns)
        r_p = nrm([Kx[i] - v[i] for i in range(n)])
        p_scale = torch.maximum(nrm(Kx), nrm(v)) + 1e-12
        s = [self.psi_fns[i].dag_adjoint(v[i] - v_prev[i], params) for i in range(n)]
        y = [self.psi_fns[i].dag_adjoint(u[i], params) for i in range(n)]
        Ktv = [self.psi_fns[i].dag_adjoint(v[i], params) for i in range(n)]
        d_scale = torch.maximum(nrm(y), nrm(Ktv)) + 1e-12
        return {"r_primal": r_p / p_scale, "r_dual": nrm(s) / d_scale}

    @property
    def nparams(self):
        return len(self.psi_fns) + 1

    @property
    def state_split(self):
        return [1, [len(self.psi_fns)], [len(self.psi_fns)]]


class LinearizedADMM(ADMM):
    """x-update linearized around the current iterate."""

    def _iter(self, state, rho, lam, step, params, aux):
        x, v, u = state
        b = []
        for i, fn in enumerate(self.psi_fns):
            tmp = fn.dag_adjoint(fn.dag_forward(x, params) - v[i] + u[i], params)
            b.append(x - tmp)
        x = self.least_square.solve(b, rho, params=params,
                                    var_shapes=self._var_shapes(x),
                                    prepared=aux.lsq, warm=x)
        Kx = self.K_forward(x, params)
        v_new, u_new = [], []
        for i, fn in enumerate(self.psi_fns):
            vi = fn.prox(Kx[i] + u[i], lam[i], params=params, step=step,
                         offset=aux.offsets[i]).to(Kx[i].dtype)
            v_new.append(vi)
            u_new.append(u[i] + Kx[i] - vi)
        return (x, tuple(v_new), tuple(u_new))


class ADMM_vxu(ADMM):
    """Prox-first iteration order; state (z, x_tuple, u_tuple)."""

    def _iter(self, state, rho, lam, step, params, aux):
        z, x, u = state
        Kz = self.K_forward(z, params)
        x_new = [fn.prox(Kz[i] - u[i], lam[i], params=params, step=step,
                         offset=aux.offsets[i]).to(Kz[i].dtype)
                 for i, fn in enumerate(self.psi_fns)]
        b = [x_new[i] + u[i] for i in range(len(self.psi_fns))]
        z = self.least_square.solve(b, rho, params=params,
                                    var_shapes=self._var_shapes(z),
                                    prepared=aux.lsq, warm=z)
        u_new = tuple(u[i] + x_new[i] - z for i in range(len(self.psi_fns)))
        return (z, tuple(x_new), u_new)

"""x-update solver selection (counterpart of dprox_tpu/algo/invert.py).

If an ``ext_sum_squares`` (a fused fast prox) is among the omega fns and
every other fn's linop is a bare Variable, its closed-form solve is the
whole x-update; otherwise the generic least-squares engine is built.
"""
from __future__ import annotations

from ..linop.base import Variable
from ..proxfn.sum_squares import ext_sum_squares, least_squares


def get_least_square_solver(psi_fns, omega_fns, try_diagonalize=True,
                            try_freq_diagonalize=True, linear_solve_config=None,
                            spatial_mesh=None, spatial_axis="space", spatial_batch_axis=None):
    prox_fns = psi_fns + omega_fns
    ext_sq = [fn for fn in omega_fns if isinstance(fn, ext_sum_squares)]
    for fn in ext_sq:
        if all(isinstance(f.linop, Variable) for f in prox_fns if f is not fn):
            return ext_sq[0].setup([f._b for f in omega_fns if f is not fn and f not in ext_sq])
    return least_squares(omega_fns, psi_fns, try_diagonalize, try_freq_diagonalize,
                         linear_solve_config=linear_solve_config, spatial_mesh=spatial_mesh,
                         spatial_axis=spatial_axis, spatial_batch_axis=spatial_batch_axis)

"""x-update solver selection (counterpart of dprox_tpu/algo/invert.py).

Only the generic least-squares engine is ported; the fused fast proxes
(``ext_sum_squares``) that could absorb the x-update come in a later
slice.
"""
from __future__ import annotations

from ..proxfn.sum_squares import least_squares


def get_least_square_solver(psi_fns, omega_fns, try_diagonalize=True,
                            try_freq_diagonalize=True, linear_solve_config=None):
    return least_squares(omega_fns, psi_fns, try_diagonalize, try_freq_diagonalize,
                         linear_solve_config=linear_solve_config)

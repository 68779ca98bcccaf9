"""Compressed-sensing MRI fused x-update (counterpart of
dprox_tpu/proxfn/fast/csmri.py).

The masked-Fourier data term ||M F x - y||^2 has a closed-form x-update in
the centred orthonormal Fourier domain:

    masked frequencies:    (y + rho * sum_i v_i~) / (1 + rho * n)
    unmasked frequencies:  mean_i v_i~

so the solver's state is complex (``complex_state``).
"""
from __future__ import annotations

import torch

from ...utils.fft import fft2_center, ifft2_center
from ..sum_squares import ext_sum_squares


class csmri(ext_sum_squares):
    complex_state = True
    _data = ("mask", "y")

    def __init__(self, linop, mask, y):
        super().__init__(linop)
        self._hold(mask=mask, y=y)

    def _solve(self, xtilde, rho, n, params):
        y = self._value("y", params).to(torch.complex64)
        mask = self._value("mask", params).to(torch.bool)
        z = fft2_center(xtilde.to(torch.complex64))
        masked = (rho * z + y) / (1.0 + rho * n)
        return ifft2_center(torch.where(mask, masked, z / n))

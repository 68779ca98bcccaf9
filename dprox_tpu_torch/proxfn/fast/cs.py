"""Compressive-sensing (coded-aperture) fused x-update (counterpart of
dprox_tpu/proxfn/fast/cs.py): forward A x = sum_c mask_c x_c, solved in
closed form through the rank structure with phi = sum_c mask_c^2."""
from __future__ import annotations

import torch

from ..sum_squares import ext_sum_squares


class compress_sensing(ext_sum_squares):
    _data = ("mask", "y")

    def __init__(self, linop, mask, y):
        super().__init__(linop)
        self._hold(mask=mask, y=y)

    def _solve(self, xtilde, rho, n, params):
        mask = self._value("mask", params).to(torch.float32)
        y = self._value("y", params)
        phi = torch.sum(mask ** 2, dim=1, keepdim=True)
        Ax = torch.sum(xtilde * mask, dim=1, keepdim=True)
        return (xtilde + (n * y - Ax) / (phi + n * rho) * mask) / n

"""Phase retrieval: the coded-diffraction-pattern forward and backward
and an amplitude-flow prox (counterpart of dprox_tpu/proxfn/fast/pr.py)."""
from __future__ import annotations

import torch

from ..base import HeldData, ProxFn


def cdp_forward(data, mask):
    """Coded diffraction: [B,1,H,W] complex x [B,S,H,W] mask -> [B,S,H,W]."""
    x = data.repeat(1, mask.shape[1], 1, 1)
    return torch.fft.fft2(x * mask, norm="ortho")


def cdp_backward(data, mask):
    """Adjoint of ``cdp_forward``."""
    return torch.mean(torch.fft.ifft2(data, norm="ortho") * torch.conj(mask), dim=1,
                      keepdim=True)


class phase_ret(HeldData, ProxFn):
    """``steps`` amplitude-flow gradient steps of size ``tau`` towards
    |A z| = y0 from v, with the prox's proximity term."""

    _data = ("mask", "y0")

    def __init__(self, linop, mask, y0, tau: float = 0.1, steps: int = 1):
        super().__init__(linop)
        self._hold(mask=mask, y0=y0)
        self.tau = tau
        self.steps = steps

    def _prox(self, v, lam, params=None, step=None):
        mask = self._value("mask", params)
        y0 = self._value("y0", params)
        z = v.to(torch.complex64)
        for _ in range(self.steps):
            Az = cdp_forward(z, mask)
            y_hat = torch.abs(Az) + 1e-9
            grad = cdp_backward(((y_hat - y0) / y_hat) * Az, mask)
            z = z - self.tau * (grad + lam * (z - v))
        return z

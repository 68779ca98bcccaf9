"""Single-photon-imaging fused x-update (counterpart of
dprox_tpu/proxfn/fast/spi.py): the prox of the binary Poisson likelihood
by ten masked bisection steps."""
from __future__ import annotations

import torch

from ..sum_squares import ext_sum_squares


def kron(a, b):
    """Batched Kronecker product over the last two axes."""
    siz = (a.shape[-2] * b.shape[-2], a.shape[-1] * b.shape[-1])
    res = a[..., :, None, :, None] * b[..., None, :, None, :]
    return res.reshape(res.shape[:-4] + siz)


def spi_forward(x, K, alpha, q, generator: torch.Generator = None):
    """Binary Poisson observation of ``x`` upsampled K-fold; the counts
    come from ``generator`` (the JAX package takes a key, so the draws
    differ)."""
    ones = torch.ones((1, 1, K, K), dtype=x.dtype, device=x.device)
    theta = alpha * kron(x, ones) / (K ** 2)
    y = torch.poisson(theta, generator=generator).to(torch.float32)
    return (y >= q).to(torch.float32)


def spi_inverse(ztilde, K1, K, mu):
    """Prox of the SPI likelihood by masked bisection (alpha == K, q == 1)."""
    K0 = K ** 2 - K1
    z_zero = ztilde - K0 / mu

    def func(y):
        return K1 / (torch.exp(y) - 1.0) - mu * y - K0 + mu * ztilde

    bmin = 1e-5 * torch.ones_like(ztilde)
    bmax = 1.1 * torch.ones_like(ztilde)
    for _ in range(10):
        bave = (bmin + bmax) / 2.0
        t = func(bave)
        bmin = torch.where(t > 0, bave, bmin)
        bmax = torch.where(t < 0, bave, bmax)
    z = torch.where(K1 == 0, z_zero, (bmin + bmax) / 2.0)
    # maximum/minimum split a tie's gradient as jnp.clip does
    return torch.minimum(torch.maximum(z, z.new_zeros(())), z.new_ones(()))


class spi(ext_sum_squares):
    _data = ("K", "y")

    def __init__(self, linop, K, y):
        super().__init__(linop)
        self._hold(K=K, y=y)

    def _solve(self, xtilde, rho, n, params):
        K = self._value("K", params) * 10
        K1 = self._value("y", params) * (K ** 2)
        return spi_inverse(xtilde, K1, K, rho)

"""Separable proxfns: nonneg projection, L1 soft-threshold, L2 shrinkage.

Counterpart of dprox_tpu/proxfn/simple.py. Pure elementwise maps; inside
ADMM the ``nonneg`` and ``norm1`` updates run fused with the dual update
in one kernel (algo/admm.py, ops/kernels.py::fused_admm_update), whose
arithmetic is the one written here. The bounds are ``torch.maximum``, not
``torch.clamp``: at a tie it splits the gradient evenly, as the JAX
package's ``jnp.maximum`` does (``torch.clamp`` passes all of it).
"""
from __future__ import annotations

import torch

from .base import ProxFn


def soft_threshold(v, lam):
    """argmin_x lam*|x|_1 + 0.5 (x-v)^2."""
    m = torch.abs(v) - lam
    return torch.sign(v) * torch.maximum(m, m.new_zeros(()))


class nonneg(ProxFn):
    """Indicator of x >= 0."""

    def _prox(self, v, lam, params=None, step=None):
        return torch.maximum(v, v.new_zeros(()))


class norm1(ProxFn):
    def _prox(self, v, lam, params=None, step=None):
        return soft_threshold(v, lam)


class norm2(ProxFn):
    def _prox(self, v, lam, params=None, step=None):
        return v / (1.0 + 2.0 * lam)

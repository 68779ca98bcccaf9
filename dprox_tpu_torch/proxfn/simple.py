"""Separable proxfns: nonneg projection, L1 soft-threshold, L2 shrinkage.

Counterpart of dprox_tpu/proxfn/simple.py. Pure elementwise maps; inside
ADMM the ``nonneg`` and ``norm1`` updates run fused with the dual update
in one kernel (algo/admm.py, ops/kernels.py::fused_admm_update), whose
arithmetic is the one written here.
"""
from __future__ import annotations

import torch

from .base import ProxFn


def soft_threshold(v, lam):
    """argmin_x lam*|x|_1 + 0.5 (x-v)^2."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - lam, min=0.0)


class nonneg(ProxFn):
    """Indicator of x >= 0."""

    def _prox(self, v, lam, params=None, step=None):
        return torch.clamp(v, min=0.0)


class norm1(ProxFn):
    def _prox(self, v, lam, params=None, step=None):
        return soft_threshold(v, lam)


class norm2(ProxFn):
    def _prox(self, v, lam, params=None, step=None):
        return v / (1.0 + 2.0 * lam)

"""Proxable-function protocol with scale and translate modifiers.

Counterpart of dprox_tpu/proxfn/base.py. A ProxFn wraps a linear-operator
expression K (evaluated with constants zeroed for its linear part) and
exposes

    prox(v, lam) = argmin_x f(x) + 1/(2 lam) ||x - v||^2

composed from the raw ``_prox`` through three modifiers: alpha (scaled),
beta (affine) and the offset b (translated).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..linop.base import LinOp, Params, Placeholder
from ..utils.misc import expand_to_bchw, to_tensor
from ..utils.profiling import span

Array = torch.Tensor


class ProxFn:
    def __init__(self, linop: LinOp, alpha: float = 1.0, beta: float = 1.0):
        self.linop = linop
        self.alpha = float(alpha)
        self.beta = float(beta)

    def to(self, device) -> "ProxFn":
        """Move the function's data to ``device`` (in place); returns self."""
        self.linop.to(device)
        return self

    # ------------------------------------------------------------------ #
    # Graph evaluation (linear part: constants zeroed)
    # ------------------------------------------------------------------ #

    def dag_forward(self, x: Array, params: Optional[Params] = None) -> Array:
        """Linear part K x (constants zeroed)."""
        var = self.linop.variables[0]
        return self.linop.forward({var.name: x}, params, zero_constants=True)

    def dag_adjoint(self, y: Array, params: Optional[Params] = None) -> Array:
        var = self.linop.variables[0]
        acc = self.linop.adjoint(y, params)
        return acc[var.name] if var.name in acc else torch.zeros_like(y)

    def offset(self, var_shapes: Dict[str, tuple], params: Optional[Params] = None):
        """b such that the expression is K x - b; None when the linop has
        no constants (the offset is identically zero)."""
        if not self.linop.constants:
            return None
        return -self.linop.offset(var_shapes, params)

    # ------------------------------------------------------------------ #
    # Prox
    # ------------------------------------------------------------------ #

    def _prox(self, v: Array, lam: Array, params: Optional[Params] = None,
              step=None) -> Array:
        raise NotImplementedError

    def prox(self, v: Array, lam, params: Optional[Params] = None, step=None,
             offset: Optional[Array] = None) -> Array:
        """Full prox with modifiers; ``offset`` may come precomputed
        (solvers hoist it out of the iteration loop). Traced as the span
        ``dprox.prox`` (utils/profiling.py)."""
        with span("dprox.prox"):
            lam = torch.as_tensor(lam, device=v.device)
            lam = expand_to_bchw(lam.real if lam.is_complex() else lam)  # real under complex states
            if offset is None and self.linop.constants:
                var = self.linop.variables[0]
                offset = self.offset({var.name: v.shape}, params)

            def scaled(v_, lam_):  # alpha * f
                if self.alpha != 1.0:
                    lam_ = lam_ * self.alpha
                return self._prox(v_, lam_, params=params, step=step)

            def affine(v_, lam_):  # f(beta x)
                if self.beta == 1.0:
                    return scaled(v_, lam_)
                return (1.0 / self.beta) * scaled(self.beta * v_, self.beta * self.beta * lam_)

            if offset is None:  # translated: f(y - b)
                return affine(v, lam)
            return affine(v - offset, lam) + offset

    # ------------------------------------------------------------------ #
    # Algebra: scalar * fn sets alpha; fn + fn builds objective lists
    # ------------------------------------------------------------------ #

    def __mul__(self, other):
        if np.isscalar(other) and other > 0:
            self.alpha = float(other)
            return self
        raise TypeError("Can only multiply a ProxFn by a positive scalar.")

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, ProxFn):
            return [self, other]
        if isinstance(other, list):
            return [self] + other
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, list):
            return other + [self]
        return NotImplemented

    def __repr__(self):
        return f"{type(self).__name__}"


class HeldData:
    """Data of a prox (a mask, an observation, a kernel) named in
    ``_data``, each kept as a ``Placeholder`` (its value from ``params``)
    or as a batched tensor on the prox's device."""

    _data = ()

    def _hold(self, **data):
        for name, x in data.items():
            setattr(self, name, x if isinstance(x, Placeholder) else to_tensor(x, batch=True))

    def to(self, device):
        super().to(device)
        for name in self._data:
            setattr(self, name, getattr(self, name).to(device))
        return self

    def _value(self, name, params):
        x = getattr(self, name)
        return x.value(params) if isinstance(x, Placeholder) else x

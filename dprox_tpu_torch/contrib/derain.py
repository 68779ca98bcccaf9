"""Learnable degradation operator for deraining (DGUNet-style).

Counterpart of dprox_tpu/contrib/derain.py: step-indexed ResBlock
networks phi / phi^T acting as a learned forward operator and its
adjoint. The step rule picks among first / middle / last parameter sets:
step 0 -> ``_0``, step ``max_step + 1`` -> ``_6``, any other -> ``_1``.
Weights travel in the solve's ``params[param_key]`` as {name: ResBlock
state dict}, so joint training differentiates through the operator.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from ..linop.ops import BlackBox


class ResBlock(nn.Module):
    """conv(3->64)-PReLU-conv(64->3) residual; the last conv starts at zero,
    so an untrained operator is the identity."""

    def __init__(self, n_feats: int = 3):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feats, 64, 3, padding=1), nn.PReLU(),
                                  nn.Conv2d(64, n_feats, 3, padding=1))
        nn.init.zeros_(self.body[2].weight)
        nn.init.zeros_(self.body[2].bias)

    def forward(self, x):
        return x + self.body(x)


class _DegOpBox(BlackBox):
    """The operator's ``BlackBox``; moving it moves the networks."""

    def __init__(self, arg, deg_op):
        super().__init__(arg, deg_op.forward, deg_op.adjoint)
        self.deg_op = deg_op

    def to(self, device):
        super().to(device)
        self.deg_op.to(device)
        return self


class LearnableDegOp:
    """Step-indexed ResBlocks exposing ``forward`` / ``adjoint`` closures
    for ``BlackBox`` (``as_linop``)."""

    def __init__(self, diag: bool = False, max_step: int = 5, param_key: str = "deg_op"):
        self.diag = diag
        self.max_step = max_step
        self.param_key = param_key
        names = ["phi_0", "phi_1", "phi_6", "phit_0", "phit_1", "phit_6"]
        if diag:
            names += ["phid_0", "phid_1", "phid_6"]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.modules = nn.ModuleDict({n: ResBlock() for n in names})
        self.modules.requires_grad_(False)

    def to(self, device):
        self.modules.to(device)
        return self

    @property
    def params(self):
        """{name: state dict}, the form ``params[param_key]`` takes."""
        return {n: dict(m.state_dict()) for n, m in self.modules.items()}

    def _select(self, kind: str, step) -> str:
        step = int(step) if step is not None else 0
        if step == 0:
            return f"{kind}_0"
        if step == self.max_step + 1:
            return f"{kind}_6"
        return f"{kind}_1"

    def _apply(self, kind, x, params, step):
        name = self._select(kind, step)
        if params and self.param_key in params:
            return functional_call(self.modules[name], params[self.param_key][name], (x,))
        return self.modules[name](x)

    def forward(self, x, params=None, step=None):
        return self._apply("phi", x, params, step)

    def adjoint(self, x, params=None, step=None):
        return self._apply("phit", x, params, step)

    def diag_fn(self, shape, params=None, step=None):
        raise NotImplementedError("diag variant used only with explicit x")

    def as_linop(self, arg):
        return _DegOpBox(arg, self)

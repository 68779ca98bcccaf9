"""Learnable per-step denoiser prior for unrolled solvers.

Counterpart of dprox_tpu/proxfn/unrolled.py: a DGUNet-style proximal
network whose behaviour depends on the unrolling step. The cross-stage
context is an explicit carry held between iterations; a proxfn that
carries state sets ``stateful = True``, the solver resets it at the start
of every solve (``Algorithm._run``), and the step index is a plain int.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call

from ..models.convert import load_torch_state_dict
from ..models.dgu import DGUDenoiser
from ..utils.checkpoint import dgu_state_dict_from_flax, load_flax_msgpack
from .base import ProxFn


class unrolled_prior(ProxFn):
    """Step 0 runs the network's first stage, step ``max_step - 1`` its
    last, every other step a middle stage on the carry; ``lam`` is not
    used. ``params[param_key]`` (a DGUDenoiser state dict) replaces the
    network's weights when given. ``ckpt_path``: a reference DGUNet
    state dict (``.pth``, the reference's names) or a flax ``.msgpack``."""

    stateful = True

    def __init__(self, linop, denoiser: Optional[DGUDenoiser] = None,
                 max_step: Optional[int] = None, param_key: Optional[str] = None,
                 ckpt_path: Optional[str] = None):
        super().__init__(linop)
        if denoiser is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                denoiser = DGUDenoiser()
        self.module = denoiser.requires_grad_(False).eval()
        self.param_key = param_key
        self.max_step = max_step
        self._carry = None
        if ckpt_path is not None:
            if str(ckpt_path).endswith(".msgpack"):
                sd = dgu_state_dict_from_flax(load_flax_msgpack(ckpt_path),
                                              self.module.state_dict().keys())
            else:
                sd = load_torch_state_dict(ckpt_path)
            self.module.load_state_dict(sd)

    def to(self, device):
        super().to(device)
        self.module.to(device)
        return self

    @property
    def params(self):
        """The network's weights (``state_dict`` names)."""
        return dict(self.module.state_dict())

    def reset(self):
        self._carry = None

    def _net(self, p, v, stage, carry=None):
        if p is None:
            return self.module(v, stage, carry)
        return functional_call(self.module, p, (v, stage, carry))

    def _prox(self, v, lam, params=None, step=None):
        p = None
        if self.param_key is not None and params and self.param_key in params:
            p = params[self.param_key]
        step = int(step) if step is not None else 0
        if step == 0:
            self._carry = None
        if self._carry is None:
            out, self._carry = self._net(p, v, "first")
        elif self.max_step is not None and step == self.max_step - 1:
            out = self._net(p, v, "last", self._carry)
        else:
            out, self._carry = self._net(p, v, "middle", self._carry)
        return out

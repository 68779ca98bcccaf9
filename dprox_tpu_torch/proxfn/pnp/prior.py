"""Plug-and-play deep denoiser prior.

Counterpart of dprox_tpu/proxfn/pnp/prior.py (``deep_prior`` without the
spatial-mesh branch, ``get_denoiser`` for the kinds this port carries):
the prox of the learned prior is a denoiser evaluated at a noise level
derived from lam.
"""
from __future__ import annotations

import warnings
from typing import Optional, Union

import torch

from ...utils.misc import safe_sqrt
from ..base import ProxFn
from .denoisers import Denoiser, DeepTVDenoiser, FFDNetColorDenoiser, TVDenoiser
from .hub import find_weights as _find_weights


def find_weights(filename: str, kind: Optional[str] = None) -> Optional[str]:
    """Path of a shipped weight file; warns when it is missing, since the
    denoiser then runs untrained."""
    path = _find_weights(filename)
    if path is None:
        warnings.warn(
            f"weights '{filename}'{f' for denoiser {kind!r}' if kind else ''} "
            "not found in weights/ — the denoiser will run with "
            "RANDOM-INITIALIZED parameters.", stacklevel=3)
    return path


def get_denoiser(kind: str) -> Denoiser:
    """Denoiser registry keyed by name."""
    if kind == "tv":
        return TVDenoiser()
    if kind == "distilled_color":
        # single color FFDNet student distilled from an x8 two-net ensemble
        return FFDNetColorDenoiser(
            ckpt_path=find_weights("distilled_ffdnet_color.msgpack", kind),
            nc=96, nb=10, residual=True)
    if kind == "distilled_color_tv":
        # the flagship prior: 0.6 * distilled FFDNet + 0.4 * TV (10 iterations)
        return DeepTVDenoiser(get_denoiser("distilled_color"), weight=0.6)
    raise KeyError(f"unknown or not yet ported denoiser '{kind}' "
                   "(ported: 'tv', 'distilled_color', 'distilled_color_tv')")


class deep_prior(ProxFn):
    def __init__(self, linop, denoiser: Union[str, Denoiser] = "distilled_color_tv",
                 clamp: bool = False, sqrt: bool = False):
        super().__init__(linop)
        self.name = denoiser if isinstance(denoiser, str) else type(denoiser).__name__
        self.denoiser = get_denoiser(denoiser) if isinstance(denoiser, str) else denoiser
        self.clamp = clamp
        self.sqrt = sqrt

    def to(self, device):
        super().to(device)
        self.denoiser.to(device)
        return self

    def eval(self, v):
        raise NotImplementedError("deep prior cannot be explicitly evaluated")

    def _prox(self, v, lam, params=None, step=None):
        sigma = safe_sqrt(lam) if self.sqrt else lam
        if self.clamp:
            v = torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_ones(()))
        if v.is_complex():
            v = v.real
        inp = v[:, None] if v.ndim == 3 else v
        out = self.denoiser.denoise(inp, sigma.reshape(-1))
        return out.to(v.dtype).reshape(v.shape)

    def __repr__(self):
        return f'deep_prior(denoiser="{self.name}")'

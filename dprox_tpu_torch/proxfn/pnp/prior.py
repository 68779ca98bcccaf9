"""Plug-and-play deep denoiser prior.

Counterpart of dprox_tpu/proxfn/pnp/prior.py: ``deep_prior`` (with
``x8``, ``param_key`` and ``unroll_step``; without the spatial mesh) and
``get_denoiser`` for TV and the FFDNet family whose weights ship
in ``weights/``, gray and color, with the DeepTV fusions and the
bfloat16 flagship. The prox of the learned prior is a denoiser evaluated
at a noise level derived from lam. Trainable denoiser weights travel in
the solver's ``params`` dict under ``param_key`` (a weight dict with the
network's ``state_dict`` names), so unrolled and DEQ training
differentiate through the prox.
"""
from __future__ import annotations

import warnings
from typing import Optional, Union

import torch

from ...utils.misc import safe_sqrt
from ..base import ProxFn
from .denoisers import (Augment, BF16Denoiser, Denoiser, DeepTVDenoiser, FFDNetColorDenoiser,
                        FFDNetDenoiser, TVDenoiser, denoise_with)
from .hub import find_weights as _find_weights


def find_weights(filename: str, kind: Optional[str] = None) -> Optional[str]:
    """Path of a shipped weight file; warns when it is missing, since the
    denoiser then runs untrained."""
    path = _find_weights(filename)
    if path is None:
        warnings.warn(
            f"weights '{filename}'{f' for denoiser {kind!r}' if kind else ''} "
            "not found in weights/ — the denoiser will run with "
            "RANDOM-INITIALIZED parameters.", stacklevel=4)
    return path


# Denoiser registry: kind -> constructor. ``ffdnet`` and ``ffdnet_color``
# have no shipped weights and run untrained, with a warning.
_REGISTRY = {
    "tv": lambda kind: TVDenoiser(),
    "ffdnet": lambda kind: FFDNetDenoiser(ckpt_path=find_weights("ffdnet_gray.pth", kind)),
    "tiny_ffdnet": lambda kind: FFDNetDenoiser(
        ckpt_path=find_weights("tiny_ffdnet_gray.msgpack", kind), nc=32, nb=8),
    "res_ffdnet": lambda kind: FFDNetDenoiser(
        ckpt_path=find_weights("res_ffdnet_gray.msgpack", kind), nc=64, nb=10, residual=True),
    "res_ffdnet_tv": lambda kind: DeepTVDenoiser(get_denoiser("res_ffdnet"), weight=0.4),
    # gray student distilled from the x8 res_ffdnet teacher
    "distilled_gray": lambda kind: FFDNetDenoiser(
        ckpt_path=find_weights("distilled_ffdnet_gray.msgpack", kind),
        nc=64, nb=10, residual=True),
    "distilled_gray_tv": lambda kind: DeepTVDenoiser(get_denoiser("distilled_gray"), weight=0.4),
    "ffdnet_color": lambda kind: FFDNetColorDenoiser(
        ckpt_path=find_weights("ffdnet_color.pth", kind)),
    "tiny_ffdnet_color": lambda kind: FFDNetColorDenoiser(
        ckpt_path=find_weights("tiny_ffdnet_color.msgpack", kind), nc=32, nb=8),
    "res_ffdnet_color": lambda kind: FFDNetColorDenoiser(
        ckpt_path=find_weights("res_ffdnet_color.msgpack", kind), nc=96, nb=10, residual=True),
    "res_ffdnet_color_tv": lambda kind: DeepTVDenoiser(get_denoiser("res_ffdnet_color"),
                                                       weight=0.5),
    # single color FFDNet student distilled from an x8 two-net ensemble
    "distilled_color": lambda kind: FFDNetColorDenoiser(
        ckpt_path=find_weights("distilled_ffdnet_color.msgpack", kind),
        nc=96, nb=10, residual=True),
    # the flagship prior: 0.6 * distilled FFDNet + 0.4 * TV (10 iterations)
    "distilled_color_tv": lambda kind: DeepTVDenoiser(get_denoiser("distilled_color"),
                                                      weight=0.6),
    # the flagship with its network in bfloat16; TV and the fusion in float32
    "distilled_color_tv_bf16": lambda kind: DeepTVDenoiser(
        BF16Denoiser(get_denoiser("distilled_color")), weight=0.6),
}
PORTED_KINDS = tuple(_REGISTRY)


def get_denoiser(kind: str) -> Denoiser:
    """Denoiser registry keyed by name (``PORTED_KINDS``)."""
    if kind not in _REGISTRY:
        raise KeyError(f"unknown or not yet ported denoiser '{kind}' "
                       f"(ported: {', '.join(PORTED_KINDS)})")
    return _REGISTRY[kind](kind)


class deep_prior(ProxFn):
    """``x8=True`` wraps the denoiser in the dihedral self-ensemble
    ``Augment`` (eight denoiser calls per prox). ``param_key``: the
    denoiser runs with ``params[param_key]`` in place of its own weights
    when the solve's params hold that key. ``unroll_step=n``: n unshared
    copies of the weights, stacked along a leading axis
    (``unrolled_params``), iteration k taking copy min(k, n - 1); a
    ``params[param_key]`` is then stacked the same way."""

    def __init__(self, linop, denoiser: Union[str, Denoiser] = "ffdnet", x8: bool = False,
                 clamp: bool = False, trainable: bool = False, unroll_step: Optional[int] = None,
                 sqrt: bool = False, param_key: Optional[str] = None):
        super().__init__(linop)
        self.name = denoiser if isinstance(denoiser, str) else type(denoiser).__name__
        self.denoiser = get_denoiser(denoiser) if isinstance(denoiser, str) else denoiser
        if x8:
            self.denoiser = Augment(self.denoiser)
        self.clamp = clamp
        self.sqrt = sqrt
        self.trainable = trainable
        self.param_key = param_key
        self.unroll = unroll_step is not None
        self.unroll_step = unroll_step
        if self.unroll:
            self.unrolled_params = {k: torch.stack([v] * unroll_step)
                                    for k, v in self.denoiser.params.items()}

    def to(self, device):
        super().to(device)
        self.denoiser.to(device)
        if self.unroll:
            self.unrolled_params = {k: v.to(device) for k, v in self.unrolled_params.items()}
        return self

    def _denoiser_params(self, params, step):
        if self.param_key is not None and params and self.param_key in params:
            p = params[self.param_key]
        elif self.unroll:
            p = self.unrolled_params
        else:
            return None  # the denoiser's own weights
        if self.unroll:
            idx = min(max(int(step or 0), 0), self.unroll_step - 1)
            p = {k: v[idx] for k, v in p.items()}
        return p

    def eval(self, v):
        raise NotImplementedError("deep prior cannot be explicitly evaluated")

    def _prox(self, v, lam, params=None, step=None):
        sigma = safe_sqrt(lam) if self.sqrt else lam
        if self.clamp:
            v = torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_ones(()))
        if v.is_complex():  # denoise the real part, copied out of the complex layout
            v = v.real.contiguous()
        inp = v[:, None] if v.ndim == 3 else v
        out = denoise_with(self.denoiser, inp, sigma.reshape(-1),
                           self._denoiser_params(params, step))
        return out.to(v.dtype).reshape(v.shape)

    def __repr__(self):
        return f'deep_prior(denoiser="{self.name}", unroll={self.unroll})'

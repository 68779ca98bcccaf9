"""Concrete linear operators: conv, conv_doe, grad, mosaic, mul_color,
mul_elementwise, BlackBox.

Counterpart of dprox_tpu/linop/ops.py. Circular convolutions run as FFT
pointwise multiplies (``torch.fft`` on cuFFT); OTFs of static kernels
and Bayer masks are made host-side once per shape and kept as tensors on
the operator's device, while a learned or injected PSF (``conv_doe``)
stays a tensor that gradients reach.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.fft import psf2otf, psf2otf_traced
from ..utils.imaging import bayer_mask
from .base import LinOp, Params, Placeholder


def _fftn2(x):
    return torch.fft.fftn(x, dim=(-2, -1))


def _ifftn2(x):
    return torch.fft.ifftn(x, dim=(-2, -1))


class conv(LinOp):
    """Circular convolution with a static kernel via FFT.

    forward: x -> real(ifft2(OTF * fft2(x))); adjoint multiplies by
    conj(OTF). Frequency-diagonal.
    """

    def __init__(self, arg, kernel):
        super().__init__([arg])
        self.kernel = np.asarray(kernel, dtype=np.float32)
        self._otf_cache = {}

    def _otf(self, shape) -> torch.Tensor:
        """OTF as [1,C,H,W] complex64 on the operator's device, cached per
        (shape, device)."""
        C, H, W = (int(s) for s in shape[-3:])
        key = (C, H, W, self.device)
        if key not in self._otf_cache:
            otf = psf2otf(self.kernel, (H, W, C))  # HWC
            otf = np.asarray(np.transpose(otf, (2, 0, 1))[None], np.complex64)
            self._otf_cache[key] = torch.from_numpy(otf).to(self.device)
        return self._otf_cache[key]

    def _forward(self, child_values, params):
        x = child_values[0]
        out = _ifftn2(self._otf(x.shape) * _fftn2(x))
        return out if x.is_complex() else out.real.to(x.dtype)

    def _adjoint(self, y, params):
        out = _ifftn2(torch.conj(self._otf(y.shape)) * _fftn2(y))
        return [out if y.is_complex() else out.real.to(y.dtype)]

    def is_diag(self, freq: bool = False) -> bool:
        return freq and self.children[0].is_diag(freq)

    def diag(self, shape, params=None, freq: bool = False):
        if not freq:
            raise ValueError("conv is diagonal only in the frequency domain")
        return self._otf(shape)

    def gram_diag(self, shape, params=None, freq: bool = False):
        FB = self._otf(shape)
        return torch.abs(torch.conj(FB) * FB)

    def _own_gram_surrogate(self, shape, params=None):
        return self.gram_diag(shape, params, freq=True)


class grad(conv):
    """Finite-difference gradient as circular conv with [1, -1].

    dim: 0 = height, 1 = width, 2 = channel.
    """

    def __init__(self, arg, dim: int = 1):
        if dim not in (0, 1, 2):
            raise ValueError("dim must be 0 (H), 1 (W) or 2 (C)")
        D = np.array([1.0, -1.0], dtype=np.float32).reshape(1, 1, 2)
        super().__init__(arg, kernel=np.swapaxes(D, dim, -1))
        self.dim = dim


class conv_doe(LinOp):
    """Circular or linearised convolution with a learned or injected PSF.

    The PSF is a ``Placeholder`` (its value from ``params``, differentiable:
    the DOE co-design path) or a fixed array. ``circular=False`` pads the
    image to twice its size, convolves circularly and crops.
    """

    def __init__(self, arg, psf, circular: bool = True):
        super().__init__([arg])
        self.circular = circular
        if isinstance(psf, Placeholder):
            self._psf_ph, self._psf_val = psf, None
        else:
            self._psf_ph = None
            if not isinstance(psf, torch.Tensor):
                psf = np.asarray(psf)
            self._psf_val = torch.as_tensor(psf)
            if self._psf_val.ndim == 3:
                self._psf_val = self._psf_val[None]

    def to(self, device):
        super().to(device)
        if self._psf_ph is not None:
            self._psf_ph.to(device)
        else:
            self._psf_val = self._psf_val.to(device)
        return self

    def psf(self, params: Optional[Params]):
        p = self._psf_ph.value(params) if self._psf_ph is not None else self._psf_val
        return p[None] if p.ndim == 3 else p

    @staticmethod
    def _pads(n):
        pad = n / 2  # to twice the size
        return int(np.ceil(pad)), int(np.floor(pad))

    def _apply(self, img, params, conj_otf: bool):
        if not self.circular:
            top, bottom = self._pads(img.shape[2])
            left, right = self._pads(img.shape[3])
            img = F.pad(img, (left, right, top, bottom))
        otf = psf2otf_traced(self.psf(params), img.shape[-2:])
        if conj_otf:
            otf = torch.conj(otf)
        out = _ifftn2(otf * _fftn2(img)).real.to(torch.float32)
        if not self.circular:
            out = out[:, :, top:-bottom, left:-right]
        return out

    def _forward(self, child_values, params):
        return self._apply(child_values[0], params, conj_otf=False)

    def _adjoint(self, y, params):
        return [self._apply(y, params, conj_otf=True)]

    def is_diag(self, freq: bool = False) -> bool:
        return freq and self.circular and self.children[0].is_diag(freq)

    def diag(self, shape, params=None, freq: bool = False):
        if not freq:
            raise ValueError("conv_doe is diagonal only in the frequency domain")
        return psf2otf_traced(self.psf(params), shape[-2:])

    def gram_diag(self, shape, params=None, freq: bool = False):
        otf = psf2otf_traced(self.psf(params), shape[-2:])
        return torch.abs(torch.conj(otf) * otf)

    def _own_gram_surrogate(self, shape, params=None):
        # circular: exact; linearised: the circulant part, still an SPD
        # preconditioner
        return self.gram_diag(shape, params, freq=True)


class mosaic(LinOp):
    """Bayer RGGB masking; self-adjoint, spatially diagonal."""

    def __init__(self, arg):
        super().__init__([arg])
        self._mask_cache = {}

    def mask(self, shape) -> torch.Tensor:
        """RGGB mask as [1,3,H,W] float32 on the operator's device, cached
        per (shape, device)."""
        key = (int(shape[-2]), int(shape[-1]), self.device)
        if key not in self._mask_cache:
            self._mask_cache[key] = torch.from_numpy(bayer_mask(key[:2])).to(self.device)
        return self._mask_cache[key]

    def _forward(self, child_values, params):
        x = child_values[0]
        return self.mask(x.shape) * x

    def _adjoint(self, y, params):
        return [self.mask(y.shape) * y]

    def is_diag(self, freq: bool = False) -> bool:
        return (not freq) and self.children[0].is_diag(freq)

    def is_gram_diag(self, freq: bool = False) -> bool:
        return (not freq) and self.children[0].is_gram_diag(freq)

    def diag(self, shape, params=None, freq: bool = False):
        if freq:
            raise ValueError("mosaic is diagonal only in the spatial domain")
        return self.mask(shape)

    def gram_diag(self, shape, params=None, freq: bool = False):
        return self.diag(shape, params, freq)  # the mask is 0/1: mask^2 == mask

    def _own_gram_surrogate(self, shape, params=None):
        # spatial average per channel (R 1/4, G 1/2, B 1/4): the circulant
        # surrogate of the Bayer mask, channel structure kept
        return torch.mean(self.mask(shape), dim=(-2, -1), keepdim=True)


class mul_color(LinOp):
    """Spectral-response colour-matrix multiply, y = srf^T x over the
    channels; ``srf`` [C_in, C_out] (multispectral SR)."""

    def __init__(self, arg, srf):
        super().__init__([arg])
        if isinstance(srf, Placeholder):
            self._srf_ph, self._srf_val = srf, None
        else:
            self._srf_ph, self._srf_val = None, torch.as_tensor(np.asarray(srf, np.float32))

    def to(self, device):
        super().to(device)
        if self._srf_ph is not None:
            self._srf_ph.to(device)
        else:
            self._srf_val = self._srf_val.to(device)
        return self

    def srf(self, params):
        srf = self._srf_ph.value(params) if self._srf_ph is not None else self._srf_val
        return srf.reshape(srf.shape[0], srf.shape[1]) if srf.ndim > 2 else srf

    def _forward(self, child_values, params):
        return torch.einsum("bchw,co->bohw", child_values[0], self.srf(params))

    def _adjoint(self, y, params):
        return [torch.einsum("bohw,co->bchw", y, self.srf(params))]


class mul_elementwise(LinOp):
    """Elementwise multiply by a fixed or injected weight; spatially diagonal."""

    def __init__(self, arg, weight):
        super().__init__([arg])
        if isinstance(weight, Placeholder):
            self._w_ph, self._w_val = weight, None
        else:
            self._w_ph, self._w_val = None, torch.as_tensor(weight, dtype=torch.float32)

    def to(self, device):
        super().to(device)
        if self._w_ph is not None:
            self._w_ph.to(device)
        else:
            self._w_val = self._w_val.to(device)
        return self

    def weight(self, params):
        if self._w_ph is not None:
            return self._w_ph.value(params)
        return self._w_val

    def _forward(self, child_values, params):
        return self.weight(params) * child_values[0]

    def _adjoint(self, y, params):
        return [self.weight(params) * y]

    def is_diag(self, freq: bool = False) -> bool:
        return (not freq) and self.children[0].is_diag(freq)

    def is_gram_diag(self, freq: bool = False) -> bool:
        return (not freq) and self.children[0].is_gram_diag(freq)

    def diag(self, shape, params=None, freq: bool = False):
        if freq:
            raise ValueError("mul_elementwise is diagonal only in the spatial domain")
        return self.weight(params)

    def gram_diag(self, shape, params=None, freq: bool = False):
        w = self.diag(shape, params, freq)
        return w * w

    def _own_gram_surrogate(self, shape, params=None):
        w = self.weight(params)
        return torch.mean(w * w, dim=(-2, -1), keepdim=True)


class BlackBox(LinOp):
    """An operator given by user closures ``forward_fn(x, params=, step=)``
    and ``adjoint_fn(y, params=, step=)``; ``step`` is the running
    solver's iteration index (``params["__step__"]``), so an operator can
    change with the iteration. ``diag_fn(shape, params=, step=)`` with
    ``freq_diag`` declares it (frequency-)diagonal and opens the direct
    x-update; it has no preconditioner surrogate."""

    def __init__(self, arg, forward_fn: Callable, adjoint_fn: Callable,
                 diag_fn: Optional[Callable] = None, freq_diag: bool = False,
                 norm_bound_val: float = 1.0):
        super().__init__([arg])
        self.forward_fn = forward_fn
        self.adjoint_fn = adjoint_fn
        self.diag_fn = diag_fn
        self.freq_diag = freq_diag
        self.norm_bound_val = norm_bound_val

    @staticmethod
    def _step(params):
        if params is not None and "__step__" in params:
            return params["__step__"]
        return 0

    def _forward(self, child_values, params):
        return self.forward_fn(child_values[0], params=params, step=self._step(params))

    def _adjoint(self, y, params):
        return [self.adjoint_fn(y, params=params, step=self._step(params))]

    def is_diag(self, freq: bool = False) -> bool:
        return (self.diag_fn is not None and freq == self.freq_diag
                and self.children[0].is_diag(freq))

    def is_gram_diag(self, freq: bool = False) -> bool:
        return self.is_diag(freq)

    def diag(self, shape, params=None, freq: bool = False):
        if self.diag_fn is None:
            raise ValueError("this BlackBox has no diag_fn")
        return self.diag_fn(shape, params=params, step=self._step(params))


def LinOpFactory(forward, adjoint, diag=None, freq_diag=False, norm_bound=1.0):
    """A function that wraps its argument in a ``BlackBox`` of these
    closures. With ``diag`` and ``freq_diag=True`` the operator is
    frequency-diagonal and x-updates take the closed-form FFT division by
    its gram diagonal |diag|^2 (``diag`` may be complex)."""

    def build(arg):
        return BlackBox(arg, forward, adjoint, diag, freq_diag, norm_bound)

    return build

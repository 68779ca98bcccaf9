"""Concrete linear operators: conv, grad, mosaic, mul_elementwise.

Counterpart of dprox_tpu/linop/ops.py. Circular convolutions run as FFT
pointwise multiplies (``torch.fft`` on cuFFT); OTFs of static kernels
and Bayer masks are made host-side once per shape and kept as tensors on
the operator's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.fft import psf2otf
from ..utils.imaging import bayer_mask
from .base import LinOp, Placeholder


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

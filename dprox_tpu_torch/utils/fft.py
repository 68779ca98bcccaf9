"""FFT helpers: the centred orthonormal transforms and ``psf2otf``.

Counterpart of dprox_tpu/utils/fft.py. Two conventions coexist:

* ``fft2_center`` / ``ifft2_center``: centred, orthonormal 2-D FFT
  (ifftshift -> fft2(norm='ortho') -> fftshift), used by the CS-MRI fast
  prox and masked-Fourier operators;
* plain ``torch.fft.fft2`` over the last two axes (uncentred,
  unnormalised), used by circular convolutions and the frequency-diagonal
  least-squares solve.

``psf2otf`` is MATLAB's, computed host-side in NumPy (PSF kernels are
static data); ``psf2otf_traced`` takes a PSF tensor and is differentiable
in it under autograd (learned or injected PSFs, ``conv_doe``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def fft2_center(x: torch.Tensor) -> torch.Tensor:
    """Centred orthonormal 2-D FFT over the last two axes."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    return torch.fft.fftshift(torch.fft.fft2(x, norm="ortho"), dim=(-2, -1))


def ifft2_center(x: torch.Tensor) -> torch.Tensor:
    """Centred orthonormal 2-D inverse FFT over the last two axes."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    return torch.fft.fftshift(torch.fft.ifft2(x, norm="ortho"), dim=(-2, -1))


def psf2otf(psf: np.ndarray, out_shape) -> np.ndarray:
    """Zero-pad ``psf`` to ``out_shape``, circularly shift its center to
    index (0, ..., 0) and FFT (MATLAB's ``psf2otf``)."""
    psf = np.asarray(psf, dtype=np.float64)
    out_shape = tuple(int(s) for s in out_shape)
    while psf.ndim < len(out_shape):
        psf = psf[..., None]
    psf_shape = psf.shape
    if any(p > o for p, o in zip(psf_shape, out_shape)):
        raise ValueError(f"psf shape {psf_shape} exceeds out_shape {out_shape}")
    if np.all(psf == 0):
        return np.zeros(out_shape, dtype=np.complex128)
    pad = [(0, o - p) for p, o in zip(psf_shape, out_shape)]
    psf = np.pad(psf, pad, mode="constant")
    for axis, p in enumerate(psf_shape):
        psf = np.roll(psf, -int(np.floor(p / 2)), axis=axis)
    otf = np.fft.fftn(psf)
    n_ops = np.sum(psf.size * np.log2(np.array(psf.shape)))
    return np.real_if_close(otf, tol=float(n_ops))


def _pads(pad: int):
    """(before, after) of the JAX package's symmetric PSF padding."""
    if pad % 2:
        return -(-pad // 2), pad // 2
    return pad // 2 + 1, pad // 2 - 1


def psf2otf_traced(psf: torch.Tensor, out_hw, torch_compat_shift: bool = True) -> torch.Tensor:
    """OTF of a PSF tensor, [..., fh, fw] -> [..., H, W] complex.

    Pads the PSF symmetrically to (H, W), then ifftshifts so its center
    sits at (0, 0) before the FFT; differentiable in ``psf``.
    ``torch_compat_shift`` shifts every axis, as the reference's
    ``torch.fft.ifftshift`` without dims does (for a [1, 3, h, w] PSF this
    also rolls the colour axis; trained DOE checkpoints depend on it);
    False shifts the two spatial axes only.
    """
    H, W = int(out_hw[0]), int(out_hw[1])
    fh, fw = psf.shape[-2], psf.shape[-1]
    if (H, W) != (fh, fw):
        top, bottom = _pads(H - fh)
        left, right = _pads(W - fw)
        psf = F.pad(psf, (left, right, top, bottom))
    dims = tuple(range(psf.ndim)) if torch_compat_shift else (-2, -1)
    return torch.fft.fft2(torch.fft.ifftshift(psf, dim=dims))

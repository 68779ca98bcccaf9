"""The plain reference's operators, in plain PyTorch and NumPy.

Written from the mathematics the port states (and, where the port's own
plain code is already plain, frozen copies of it): MATLAB's psf2otf, the
circular convolution, the RGGB Bayer mask, bilinear demosaicking, TV
denoising by dual ascent (Chambolle's projection with step 1/5) and the
FFDNet forward pass (Zhang, Zuo, Zhang, IEEE TIP 2018) with the noise
map as the last input channel. Nothing here imports the port.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def psf2otf(psf: np.ndarray, out_shape) -> np.ndarray:
    """Zero-pad ``psf`` to ``out_shape``, shift its centre to the origin and
    take the FFT (MATLAB's ``psf2otf``), in float64."""
    psf = np.asarray(psf, dtype=np.float64)
    out_shape = tuple(int(s) for s in out_shape)
    psf_shape = psf.shape
    psf = np.pad(psf, [(0, o - p) for p, o in zip(psf_shape, out_shape)], mode="constant")
    for axis, p in enumerate(psf_shape):
        psf = np.roll(psf, -int(np.floor(p / 2)), axis=axis)
    otf = np.fft.fftn(psf)
    n_ops = np.sum(psf.size * np.log2(np.array(psf.shape)))
    return np.real_if_close(otf, tol=float(n_ops))


def otf(psf: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """The PSF's OTF as a [1, 1, h, w] complex64 tensor."""
    return torch.from_numpy(np.asarray(psf2otf(psf, (h, w)), np.complex64))[None, None].to(device)


def conv(x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(H * torch.fft.fft2(x)).real


def conv_adjoint(y: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(torch.conj(H) * torch.fft.fft2(y)).real


def bayer_mask(h: int, w: int, device) -> torch.Tensor:
    """RGGB: R at (even, even), G at (even, odd) and (odd, even), B at
    (odd, odd); [1, 3, h, w] float32 of zeros and ones."""
    m = torch.zeros(1, 3, h, w, dtype=torch.float32, device=device)
    m[0, 0, 0::2, 0::2] = 1
    m[0, 1, 0::2, 1::2] = 1
    m[0, 1, 1::2, 0::2] = 1
    m[0, 2, 1::2, 1::2] = 1
    return m


def demosaic_bilinear(mosaic: torch.Tensor) -> torch.Tensor:
    """Bilinear demosaicking of an RGGB-masked [N, 3, H, W] mosaic: each
    plane's samples spread by a 3x3 kernel over the wrap-padded plane."""
    k_rb = 0.25 * torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]])
    k_g = 0.25 * torch.tensor([[0., 1., 0.], [1., 4., 1.], [0., 1., 0.]])
    weight = torch.stack([k_rb, k_g, k_rb])[:, None].to(mosaic)
    return F.conv2d(F.pad(mosaic, (1, 1, 1, 1), mode="circular"), weight, groups=3)


def tv_denoise(y0: torch.Tensor, lam, iterations: int) -> torch.Tensor:
    """TV per plane of [..., H, W] by ``iterations`` dual-ascent steps, the
    duals clipped to [-lam / 2, lam / 2]."""
    alpha = 5.0
    t = torch.as_tensor(lam, dtype=y0.dtype, device=y0.device).reshape(()) / 2.0

    def clip(z):
        return torch.minimum(torch.maximum(z, -t), t)

    def dt(z, dim):  # adjoint of the forward difference along dim
        first = -z.narrow(dim, 0, 1)
        mid = z.narrow(dim, 0, z.shape[dim] - 1) - z.narrow(dim, 1, z.shape[dim] - 1)
        return torch.cat([first, mid, z.narrow(dim, z.shape[dim] - 1, 1)], dim)

    zh = torch.zeros_like(y0[..., 1:])
    zv = torch.zeros_like(y0[..., 1:, :])
    x = y0
    for _ in range(iterations):
        x = ((y0 - dt(zh, -1)) + (y0 - dt(zv, -2))) / 2.0
        zh = clip(zh + (1.0 / alpha) * (x[..., 1:] - x[..., :-1]))
        zv = clip(zv + (1.0 / alpha) * (x[..., 1:, :] - x[..., :-1, :]))
    return x


def ffdnet(weights: Dict[str, torch.Tensor], x: torch.Tensor, sigma: torch.Tensor,
           layers: int, residual: bool) -> torch.Tensor:
    """FFDNet on [N, C, H, W] (H, W even): pixel-unshuffle by 2 (channel
    order c * 4 + dy * 2 + dx), the noise level as one more channel,
    ``layers`` 3x3 convolutions with ReLU between them, pixel-shuffle back;
    with ``residual`` the network predicts the noise."""
    z = F.pixel_unshuffle(x, 2)
    z = torch.cat([z, torch.ones_like(z[:, :1]) * sigma.reshape(-1, 1, 1, 1)], dim=1)
    for i in range(layers):
        z = F.conv2d(z, weights[f"convs.{i}.weight"], weights[f"convs.{i}.bias"], padding=1)
        if i < layers - 1:
            z = torch.relu(z)
    z = F.pixel_shuffle(z, 2)
    return x - z if residual else z


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN's and cuBLAS's TF32 modes on or off (cuDNN itself stays on):
    the control of a float32 configuration with TF32 off."""
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was

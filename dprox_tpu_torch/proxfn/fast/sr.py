"""Super-resolution fused x-updates (counterpart of
dprox_tpu/proxfn/fast/sr.py).

* ``sisr``: single-image SR with a blur-then-decimate forward model; the
  x-update inverts the sf-fold decimation in the frequency domain through
  sf^2 block means of FFT tiles (Zhang et al., DPIR).
* ``misr``: multispectral SR by per-pixel CxC normal equations solved on
  the channel axis (``torch.linalg.solve``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..sum_squares import ext_sum_squares


def splits(a, sf: int):
    """[N,C,H,W] -> [N,C,H/sf,W/sf,sf^2]: the sf*sf interleaved blocks."""
    b = torch.stack(torch.split(a, a.shape[2] // sf, dim=2), dim=4)  # N,C,H/sf,W,sf
    return torch.cat(torch.split(b, b.shape[3] // sf, dim=3), dim=4)


def p2o(psf, shape):
    """PSF [N,C,h,w] -> OTF [N,C,H,W]: zero-pad, roll the center to 0, FFT."""
    H, W = shape
    h, w = psf.shape[-2], psf.shape[-1]
    otf = torch.zeros(psf.shape[:-2] + (H, W), dtype=psf.dtype, device=psf.device)
    otf[..., :h, :w] = psf
    otf = torch.roll(otf, (-int(h / 2), -int(w / 2)), dims=(-2, -1))
    return torch.fft.fftn(otf, dim=(-2, -1))


def upsample(x, sf: int = 3):
    """Zero-filling sf-fold upsampler."""
    N, C, H, W = x.shape
    z = torch.zeros((N, C, H * sf, W * sf), dtype=x.dtype, device=x.device)
    z[..., ::sf, ::sf] = x
    return z


class sisr(ext_sum_squares):
    """||S H x - y||^2 with H = conv(kernel) and S the sf-decimation."""

    _data = ("y", "k")

    def __init__(self, linop, y, kernel, sf: int):
        super().__init__(linop)
        self.sf = int(sf)
        self._hold(y=y, k=kernel)

    def _solve(self, xtilde, rho, n, params):
        sf = self.sf
        y = self._value("y", params)
        k = self._value("k", params)
        while k.ndim < 4:  # bare 2-D/3-D kernels
            k = k[None]
        h, w = y.shape[-2:]
        FB = p2o(k, (h * sf, w * sf))
        FBC = torch.conj(FB)
        F2B = torch.abs(FB) ** 2
        FBFy = FBC * torch.fft.fftn(upsample(y, sf=sf), dim=(-2, -1))
        FR = FBFy + torch.fft.fftn(rho * xtilde, dim=(-2, -1))
        FBR = torch.mean(splits(FB * FR, sf), dim=-1)
        invW = torch.mean(splits(F2B, sf), dim=-1)
        invWBR = FBR / (invW + n * rho)
        FCBinvWBR = FBC * invWBR.repeat(1, 1, sf, sf)
        FX = (FR - FCBinvWBR) / (n * rho + 1e-9)
        return torch.fft.ifftn(FX, dim=(-2, -1)).real.to(torch.float32)


class misr(ext_sum_squares):
    """Multispectral SR, ||srf^T x - b||^2 with ``srf`` [C, 3]; per-pixel
    CxC normal equations."""

    _data = ("b", "srf")

    def __init__(self, linop, b, srf, eps: float = 1e-7):
        super().__init__(linop, eps=eps)
        self._hold(b=b)
        self.srf = torch.as_tensor(np.asarray(srf, np.float32))

    def _solve(self, xtilde, rho, n, params):
        b = self._value("b", params)
        srf = self.srf
        N, C, H, W = xtilde.shape
        T2 = srf @ srf.T
        Ttz = torch.einsum("ck,nkp->ncp", srf, b.reshape(b.shape[0], b.shape[1], -1))
        lam = torch.broadcast_to(rho.reshape(-1)[:, None, None], (N, 1, 1))
        A = T2[None] + n * lam[..., None] * torch.eye(C, device=srf.device)[None]
        x = torch.linalg.solve(A, Ttz + lam * xtilde.reshape(N, C, H * W))
        return x.reshape(N, C, H, W).to(torch.float32)

"""Image quality metrics (counterpart of dprox_tpu/utils/metrics.py: mse,
psnr, ssim, and the hyperspectral sam, ergas, mpsnr, mssim, mpsnr_max).

Metrics run host-side in float64 on HWC, CHW or BCHW inputs in [0, 1].
"""
from __future__ import annotations

import numpy as np

from .misc import debatchify, to_ndarray


def _pair(output, target):
    o = to_ndarray(output).astype(np.float64)
    t = to_ndarray(target).astype(np.float64)
    if o.ndim == 4:
        o = debatchify(o)
    if t.ndim == 4:
        t = debatchify(t)
    if o.ndim == 3 and o.shape[0] in (1, 3) and o.shape[-1] not in (1, 3):
        o = o.transpose(1, 2, 0)
        t = t.transpose(1, 2, 0)
    return o, t


def mse(output, target) -> float:
    o, t = _pair(output, target)
    return float(np.mean((o - t) ** 2))


def psnr(output, target, data_range: float = 1.0) -> float:
    m = mse(output, target)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / m))


def _ssim_2d(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0) -> float:
    """SSIM of two 2-D images with a 7x7 uniform window and the unbiased
    covariance normalization (skimage's defaults), border cropped."""
    from scipy.ndimage import uniform_filter

    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    win = 7
    mu1 = uniform_filter(img1, win)
    mu2 = uniform_filter(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    n = win * win
    cov_norm = n / (n - 1)
    sigma1_sq = cov_norm * (uniform_filter(img1 * img1, win) - mu1_sq)
    sigma2_sq = cov_norm * (uniform_filter(img2 * img2, win) - mu2_sq)
    sigma12 = cov_norm * (uniform_filter(img1 * img2, win) - mu1_mu2)
    num = (2 * mu1_mu2 + C1) * (2 * sigma12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    pad = (win - 1) // 2
    return float((num / den)[pad:-pad, pad:-pad].mean())


def ssim(output, target, data_range: float = 1.0) -> float:
    """Mean SSIM over the channels (HWC after ``_pair``)."""
    o, t = _pair(output, target)
    if o.ndim == 2:
        return _ssim_2d(o, t, data_range)
    return float(np.mean([_ssim_2d(o[..., c], t[..., c], data_range)
                          for c in range(o.shape[-1])]))


def sam(output, target, eps: float = 1e-8) -> float:
    """Spectral angle mapper (degrees), over the channel axis."""
    o, t = _pair(output, target)
    num = (o * t).sum(-1)
    den = np.sqrt((o * o).sum(-1)) * np.sqrt((t * t).sum(-1))
    return float(np.mean(np.arccos(np.clip(num / (den + eps), -1, 1))) * 180.0 / np.pi)


def ergas(output, target, r: float = 4.0) -> float:
    o, t = _pair(output, target)
    nbands = o.shape[-1]
    acc = 0.0
    for c in range(nbands):
        rmse_c = np.sqrt(np.mean((o[..., c] - t[..., c]) ** 2))
        acc += (rmse_c / (np.mean(t[..., c]) + 1e-12)) ** 2
    return float(100.0 / r * np.sqrt(acc / nbands))


def mpsnr(output, target, data_range: float = 1.0) -> float:
    """Mean per-band PSNR (hyperspectral convention)."""
    o, t = _pair(output, target)
    return float(np.mean([psnr(o[..., c], t[..., c], data_range) for c in range(o.shape[-1])]))


def mssim(output, target, data_range: float = 1.0) -> float:
    o, t = _pair(output, target)
    return float(np.mean([_ssim_2d(o[..., c], t[..., c], data_range)
                          for c in range(o.shape[-1])]))


def mpsnr_max(output, target) -> float:
    """Per-band PSNR with each band's maximum as the peak."""
    o, t = _pair(output, target)
    vals = []
    for c in range(o.shape[-1]):
        peak = float(t[..., c].max())
        vals.append(psnr(o[..., c], t[..., c], data_range=peak if peak > 0 else 1.0))
    return float(np.mean(vals))

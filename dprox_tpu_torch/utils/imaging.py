"""Sample images, PSF generators and the blur degradation.

Counterpart of dprox_tpu/utils/imaging.py (``_synthetic_face``,
``sample``, ``point_spread_function``, ``blurring``, ``masks_CFA_Bayer``,
``bayer_mask``, ``mosaicing``, ``downsampling``) and ``resize_cubic``, the
cubic ``jax.image.resize`` the JAX package calls. Sample data is
deterministic numpy; the degradations run with torch on the image's
device.
"""
from __future__ import annotations

import numpy as np
import torch

from .fft import psf2otf
from .misc import resolve_device, to_tensor


def _synthetic_face(h: int = 512, w: int = 512) -> np.ndarray:
    """Deterministic structured RGB test image in [0,1], HWC: smooth
    gradients + texture + sharp edges, so deconvolution metrics are
    meaningful."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    rng = np.random.RandomState(0)
    base = np.stack(
        [
            0.55 + 0.35 * np.sin(2 * np.pi * (3 * xx + yy)),
            0.5 + 0.3 * np.cos(2 * np.pi * (xx - 2 * yy)),
            0.45 + 0.35 * np.sin(2 * np.pi * (xx * yy * 4 + 0.3)),
        ],
        axis=-1,
    )
    for k in range(6):
        cy, cx, r = rng.randint(40, h - 40), rng.randint(40, w - 40), rng.randint(10, 60)
        mask = (yy * h - cy) ** 2 + (xx * w - cx) ** 2 < r**2
        base[mask] = rng.rand(3)
    base += 0.05 * rng.randn(h, w, 3)
    return np.clip(base, 0.0, 1.0).astype(np.float32)


def sample(name: str = "face", return_tensor: bool = True, device="cuda"):
    """Deterministic sample image in [0,1].

    Tries scipy's cached datasets first (offline cache only), else the
    synthetic 512x512 image, so the same call can give different images
    on two machines; callers that need one image everywhere use
    ``_synthetic_face`` directly.
    """
    img = None
    try:  # works only if the scipy pooch cache is pre-populated
        import scipy.datasets

        if name == "face":
            img = scipy.datasets.face().astype("float32") / 255
        elif name == "ascent":
            img = (scipy.datasets.ascent().astype("float32") / 255)[..., None]
    except Exception:
        img = None
    if img is None:
        img = _synthetic_face(512, 512)
        if name == "ascent":
            img = img.mean(-1, keepdims=True)
    if return_tensor:
        return to_tensor(img, batch=True, device=resolve_device(device)).float()
    return img


def fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian') — normalized 2-D Gaussian kernel."""
    siz = (hsize - 1.0) / 2.0
    y, x = np.meshgrid(
        np.arange(-siz, siz + 1), np.arange(-siz, siz + 1), indexing="ij"
    )
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h = h / s
    return h.astype(np.float32)


def point_spread_function(ksize: int, sigma: float) -> np.ndarray:
    """Gaussian PSF, HW1 float32."""
    return fspecial_gaussian(ksize, sigma)[..., None].astype("float32")


def blurring(img: torch.Tensor, psf: np.ndarray) -> torch.Tensor:
    """Circular (wrap) convolution of a BCHW image with a PSF via FFT."""
    img = to_tensor(img, batch=True)
    _, C, H, W = img.shape
    otf = psf2otf(np.asarray(psf).squeeze(), (H, W))
    otf = otf.astype(np.complex64 if np.iscomplexobj(otf) else np.float32)
    otf = torch.from_numpy(otf).to(img.device)[None, None]
    out = torch.fft.ifft2(otf * torch.fft.fft2(img)).real
    return out.to(img.dtype)


def masks_CFA_Bayer(shape):
    """RGGB Bayer masks, a tuple of three HxW bool arrays (R, G, B)."""
    channels = {c: np.zeros(shape) for c in "RGB"}
    for channel, (y, x) in zip("RGGB", [(0, 0), (0, 1), (1, 0), (1, 1)]):
        channels[channel][y::2, x::2] = 1
    return tuple(channels[c].astype(bool) for c in "RGB")


def bayer_mask(shape) -> np.ndarray:
    """RGGB Bayer mask as [1,3,H,W] float32."""
    return np.stack(masks_CFA_Bayer(shape), axis=0).astype(np.float32)[None]


def mosaicing(img: torch.Tensor) -> torch.Tensor:
    """Apply the Bayer RGGB mask to a BCHW RGB image."""
    img = to_tensor(img, batch=True)
    mask = torch.from_numpy(bayer_mask(tuple(img.shape[-2:]))).to(img.device)
    return mask * img


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``jax.image.resize(method="cubic")``
    along one axis: the Keys kernel with a = -0.5 at the sample points
    ``(i + 0.5) n_in / n_out - 0.5``, stretched by n_in / n_out when the
    axis shrinks (the antialiased kernel), each column divided by its sum
    (the border columns lose the taps that fall outside)."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    x = x / max(inv_scale, 1.0)
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, method="cubic")``: each axis whose size
    changes is resampled separably with ``_cubic_weights`` (up or down)."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has not the {x.ndim} axes of the input")
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = _cubic_weights(n_in, int(n_out), x.device).to(x.dtype)
            x = torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)
    return x


def downsampling(img: torch.Tensor, psf: np.ndarray, sf: int):
    """Blur (``blurring``), then keep every ``sf``-th pixel; returns
    ``(downsampled, x0)`` with x0 the cubic upsampling of the result, as
    the JAX package's ``jax.image.resize(method="cubic")`` computes it
    (separable Keys kernel, a = -0.5, renormalised at the borders)."""
    img = to_tensor(img, batch=True)
    downed = blurring(img, psf)[..., ::sf, ::sf]
    h, w = downed.shape[-2:]
    wh = _cubic_weights(h, h * sf, downed.device).to(downed.dtype)
    ww = _cubic_weights(w, w * sf, downed.device).to(downed.dtype)
    return downed, torch.einsum("bchw,hH,wW->bcHW", downed, wh, ww)

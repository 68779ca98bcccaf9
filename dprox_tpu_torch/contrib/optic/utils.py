"""Optics utilities: sample loading, PSF normalisation, the DOE sanity
check, plots and image datasets.

Counterpart of dprox_tpu/contrib/optic/utils.py. PIL and matplotlib are
imported by the functions that need them; the cubic resizes are
``utils.imaging.resize_cubic`` (``jax.image.resize``'s, antialiased when
it shrinks).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ...linop import Variable, adjoint as lin_adjoint, conv_doe, eval as lin_eval
from ...utils.imaging import resize_cubic, sample as sample_img
from ...utils.misc import outlier_correct, resolve_device
from .doe_model import img_psf_conv


def center_crop(arr: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """The central new_h x new_w region of an [H, W, ...] array."""
    h, w = arr.shape[:2]
    top = round((h - new_h) / 2)
    left = round((w - new_w) / 2)
    return arr[top:top + new_h, left:left + new_w]


def load_sample_img(path=None, keep_ratio: bool = True, patch_size: int = 748,
                    device="cuda") -> torch.Tensor:
    """A [1, 3, P, P] float32 sample in [0, 1] on ``device``: the image at
    ``path`` (its central square, or a P x P crop without ``keep_ratio``),
    else the face of ``utils.imaging.sample``, cubic-resized to P."""
    dev = resolve_device(device)
    if path is not None:
        from PIL import Image

        img = Image.open(path)
        ps = min(img.height, img.width) if keep_ratio else patch_size
        arr = center_crop(np.array(img).astype(np.float32) / 255.0, ps, ps)
        arr = resize_cubic(torch.from_numpy(np.ascontiguousarray(arr)).to(dev),
                           (patch_size, patch_size, 3))
        return arr.permute(2, 0, 1)[None]
    x = sample_img("face", device=dev)
    side = min(x.shape[-2:])
    return resize_cubic(x[:, :, :side, :side], (1, 3, patch_size, patch_size))


def sanity_check(psf, circular: bool = True, patch_size: int = 128, device="cuda"):
    """``conv_doe``'s forward against ``img_psf_conv`` (1e-4) and its
    adjoint by the dot-product test (1e-3 relative) on the sample image;
    returns (ok, image, conv_doe's output)."""
    x = load_sample_img(patch_size=patch_size, device=device)
    psf = torch.as_tensor(psf).to(x.device)
    expected = img_psf_conv(x, psf, circular=circular)
    op = conv_doe(Variable(), psf, circular=circular).to(x.device)
    out = lin_eval(op, x)
    ok = bool(torch.allclose(out, expected, atol=1e-4))
    d = torch.ones_like(out)
    ad = lin_adjoint(op, d)
    lhs = float(torch.sum(out * d))
    rhs = float(torch.sum(x * ad))
    ok = ok and abs(lhs - rhs) / (abs(lhs) + 1e-9) < 1e-3
    return ok, x, out


def normalize_psf(psf: np.ndarray, clip_percentile: float = 0.01,
                  bandwise: bool = False) -> np.ndarray:
    """PSF (HWC numpy) scaled to sum 1 (per band with ``bandwise``),
    clipped to its percentiles, then to maximum 1 for display."""
    psf = np.asarray(psf, np.float32).copy()
    if bandwise:
        psf = psf / psf.sum(axis=(0, 1), keepdims=True)
    else:
        psf = psf / psf.sum()
    psf = outlier_correct(psf, p=clip_percentile)
    return psf / psf.max()


def normalize_psf2(psf: np.ndarray, rng: float = 1.0, mode: str = "band") -> np.ndarray:
    """Per-band (``mode="band"``) or global min-max normalisation, clipped
    to [0, rng] and normalised again."""
    psf = np.asarray(psf, np.float32).copy()

    def norm(p):
        if mode == "band":
            for c in range(p.shape[-1]):
                lo, hi = p[..., c].min(), p[..., c].max()
                p[..., c] = (p[..., c] - lo) / (hi - lo + 1e-12)
        else:
            lo, hi = p.min(), p.max()
            p = (p - lo) / (hi - lo + 1e-12)
        return p

    return norm(np.clip(norm(psf), 0, rng))


def _numpy(data) -> np.ndarray:
    return data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def subplot(data, path):
    """Save the three channels of a [1, 3, H, W] array side by side, with
    colorbars, to ``path``."""
    import matplotlib.pyplot as plt

    _, axes = plt.subplots(1, 3)
    arr = _numpy(data)
    for i in range(3):
        im = axes[i].imshow(arr[0, i])
        plt.colorbar(im, ax=axes[i])
    plt.savefig(path)
    plt.close()


def plot(data, path):
    """Save one image with a colorbar to ``path``."""
    import matplotlib.pyplot as plt

    plt.figure()
    plt.imshow(_numpy(data).squeeze())
    plt.colorbar()
    plt.savefig(path)
    plt.close()


def plot3d(data, path, region=(200, 400)):
    """Save a surface plot of the [lo, hi) x [lo, hi) crop to ``path``."""
    import matplotlib.pyplot as plt

    arr = _numpy(data).squeeze()
    lo, hi = region
    lo = min(lo, max(arr.shape[0] - 1, 0))
    hi = min(hi, arr.shape[0])
    arr = arr[lo:hi, lo:hi]
    h, w = arr.shape
    X, Y = np.meshgrid(np.linspace(0, h, 50), np.linspace(0, w, 50))
    fig = plt.figure()
    ax = plt.axes(projection="3d")
    ax.plot_surface(X, Y, arr)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    plt.savefig(path)
    plt.close(fig)


class SingleImageDataset:
    """The images of a directory as (CHW float32 numpy in [0, 1], name)."""

    def __init__(self, root: str, patch_size=None):
        from ...utils.io import list_image_files

        self.root = root
        self.paths = list_image_files(root)
        self.patch_size = patch_size

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        from PIL import Image

        img = Image.open(os.path.join(self.root, path)).convert("RGB")
        return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0

    def __getitem__(self, index):
        return self._load(self.paths[index]), self.paths[index]


class Dataset(SingleImageDataset):
    """The images cubic-resized to size x size (768 by default), clipped to
    [0, 1], as CHW float32 numpy."""

    def __init__(self, root: str, size: int = 768):
        super().__init__(root)
        self.size = size

    def __getitem__(self, index):
        img, _ = super().__getitem__(index)
        img = resize_cubic(torch.from_numpy(np.ascontiguousarray(img)), (3, self.size, self.size))
        return img.clamp(0, 1).numpy()

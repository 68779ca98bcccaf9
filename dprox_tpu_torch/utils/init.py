"""Initialization helpers: demosaicking and the SR pixel shift.

Counterpart of dprox_tpu/utils/init.py (``demosaic_bilinear``,
``demosaic_from_mosaiced``, ``demosaic_ea``, ``demosaic_malvar``,
``shift_pixel``): the bilinear interpolation is a grouped 3x3 convolution
over the wrap-padded colour planes, Malvar-He-Cutler four 5x5 filters
over the reflect-padded mosaic.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .misc import to_tensor


def demosaic_bilinear(bayer_rggb: torch.Tensor) -> torch.Tensor:
    """Bilinear demosaicking of packed Bayer planes.

    Input: [N,4,H/2,W/2] (R, G1, G2, B planes) -> [N,3,H,W].
    """
    imgs = to_tensor(bayer_rggb)
    N, _, h, w = imgs.shape
    rgb = torch.zeros((N, 3, 2 * h, 2 * w), dtype=imgs.dtype, device=imgs.device)
    rgb[:, 0, 0::2, 0::2] = imgs[:, 0]
    rgb[:, 1, 0::2, 1::2] = imgs[:, 1]
    rgb[:, 1, 1::2, 0::2] = imgs[:, 2]
    rgb[:, 2, 1::2, 1::2] = imgs[:, 3]

    k_r = 0.25 * torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=imgs.dtype)
    k_g = 0.25 * torch.tensor([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dtype=imgs.dtype)
    weight = torch.stack([k_r, k_g, k_r])[:, None].to(imgs.device)  # [3,1,3,3], one per band
    padded = F.pad(rgb, (1, 1, 1, 1), mode="circular")
    # full float32 whatever the process-wide cuDNN TF32 setting is
    with torch.backends.cudnn.flags(allow_tf32=False):
        return F.conv2d(padded, weight, groups=3)


def demosaic_from_mosaiced(mosaiced: torch.Tensor) -> torch.Tensor:
    """Bilinear init from a masked RGB mosaic [N,3,H,W] (RGGB); the x0 of
    demosaicking problems."""
    return demosaic_bilinear(_bayer_planes(to_tensor(mosaiced)))


def _bayer_planes(m):
    """[N,3,H,W] RGGB mosaic -> [N,4,H/2,W/2] (R, G1, G2, B) planes."""
    return torch.stack([m[:, 0, 0::2, 0::2], m[:, 1, 0::2, 1::2],
                        m[:, 1, 1::2, 0::2], m[:, 2, 1::2, 1::2]], dim=1)


def demosaic_ea(mosaiced) -> torch.Tensor:
    """Edge-aware demosaicking init from a masked RGB mosaic [N,3,H,W]:
    OpenCV's ``COLOR_BAYER_BG2RGB_EA`` on the 8-bit mosaic where OpenCV
    imports, else ``demosaic_malvar``, as in the JAX package. Returns a
    CPU tensor for numpy input, else one on the input's device."""
    device = mosaiced.device if isinstance(mosaiced, torch.Tensor) else "cpu"
    m = np.asarray(mosaiced.detach().cpu() if isinstance(mosaiced, torch.Tensor) else mosaiced,
                   np.float32)
    try:
        import cv2
    except ImportError:  # no OpenCV: Malvar, as the JAX package does
        return demosaic_malvar(_bayer_planes(torch.from_numpy(m))).to(device)
    cfa = np.clip(m.sum(axis=1) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    out = np.stack([cv2.cvtColor(c, cv2.COLOR_BAYER_BG2RGB_EA).astype(np.float32) / 255.0
                    for c in cfa])
    return torch.from_numpy(np.ascontiguousarray(np.transpose(out, (0, 3, 1, 2)))).to(device)


def shift_pixel(x, sf: int, upper_left: bool = True) -> torch.Tensor:
    """Shift an HxW or HxWxC image by (sf - 1) / 2 pixels with bilinear
    interpolation (the SR init), as ``jax.scipy.ndimage.map_coordinates``
    with ``order=1`` computes it on coordinates clipped into the image."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                        dtype=torch.float32)
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    ys = torch.arange(h, dtype=torch.float32, device=x.device)
    xs = torch.arange(w, dtype=torch.float32, device=x.device)
    ys, xs = (ys + shift, xs + shift) if upper_left else (ys - shift, xs - shift)
    ys, xs = torch.clamp(ys, 0, h - 1), torch.clamp(xs, 0, w - 1)

    def nodes(c, size):  # (index, in range, weight) of the two neighbours
        lo = torch.floor(c)
        wu = c - lo
        lo = lo.to(torch.int64)
        return [(lo, lo < size, 1 - wu), (lo + 1, lo + 1 < size, wu)]

    out = 0.0
    for iy, vy, wy in nodes(ys, h):
        for ix, vx, wx in nodes(xs, w):
            val = x[iy.clamp(max=h - 1)[:, None], ix.clamp(max=w - 1)[None, :]]
            valid = (vy[:, None] & vx[None, :])
            if val.ndim == 3:
                valid = valid[..., None]
            weight = wy[:, None] * wx[None, :]
            out = out + (weight[..., None] if val.ndim == 3 else weight) * torch.where(
                valid, val, torch.zeros_like(val))
    return out


def demosaic_malvar(bayer_rggb: torch.Tensor) -> torch.Tensor:
    """Malvar-He-Cutler demosaicking of packed Bayer planes.

    Input: [N,4,H/2,W/2] (R, G1, G2, B) -> [N,3,H,W].
    """
    imgs = to_tensor(bayer_rggb)
    N, _, h, w = imgs.shape
    t = lambda rows: torch.tensor(rows, dtype=torch.float32)  # noqa: E731
    kgrb = t([[0, 0, -1, 0, 0], [0, 0, 2, 0, 0], [-1, 2, 4, 2, -1],
              [0, 0, 2, 0, 0], [0, 0, -1, 0, 0]]) * (1 / 8)
    krbg0 = t([[0, 0, 0.5, 0, 0], [0, -1, 0, -1, 0], [-1, 4, 5, 4, -1],
               [0, -1, 0, -1, 0], [0, 0, 0.5, 0, 0]]) * (1 / 8)
    krbbr = t([[0, 0, -1.5, 0, 0], [0, 2, 0, 2, 0], [-1.5, 0, 6, 0, -1.5],
               [0, 2, 0, 2, 0], [0, 0, -1.5, 0, 0]]) * (1 / 8)
    k = torch.stack([kgrb, krbg0, krbg0.T, krbbr])[:, None].to(imgs.device, imgs.dtype)

    cfa = torch.zeros((N, 1, 2 * h, 2 * w), dtype=imgs.dtype, device=imgs.device)
    cfa[:, 0, 0::2, 0::2] = imgs[:, 0]
    cfa[:, 0, 0::2, 1::2] = imgs[:, 1]
    cfa[:, 0, 1::2, 0::2] = imgs[:, 2]
    cfa[:, 0, 1::2, 1::2] = imgs[:, 3]
    rgb = cfa.repeat(1, 3, 1, 1)
    with torch.backends.cudnn.flags(allow_tf32=False):
        conv = F.conv2d(F.pad(cfa, (2, 2, 2, 2), mode="reflect"), k)
    rgb[:, 1, 0::2, 0::2] = conv[:, 0, 0::2, 0::2]
    rgb[:, 1, 1::2, 1::2] = conv[:, 0, 1::2, 1::2]
    rgb[:, 0, 0::2, 1::2] = conv[:, 1, 0::2, 1::2]
    rgb[:, 0, 1::2, 0::2] = conv[:, 2, 1::2, 0::2]
    rgb[:, 0, 1::2, 1::2] = conv[:, 3, 1::2, 1::2]
    rgb[:, 2, 0::2, 1::2] = conv[:, 2, 0::2, 1::2]
    rgb[:, 2, 1::2, 0::2] = conv[:, 1, 1::2, 0::2]
    rgb[:, 2, 0::2, 0::2] = conv[:, 3, 0::2, 0::2]
    return rgb

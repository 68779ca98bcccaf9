"""Initialization helpers: bilinear demosaicking.

Counterpart of dprox_tpu/utils/init.py (``demosaic_bilinear``,
``demosaic_from_mosaiced``): the bilinear interpolation is a grouped 3x3
convolution over the wrap-padded colour planes.
"""
from __future__ import annotations

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
    m = to_tensor(mosaiced)
    planes = torch.stack([m[:, 0, 0::2, 0::2], m[:, 1, 0::2, 1::2],
                          m[:, 1, 1::2, 0::2], m[:, 2, 1::2, 1::2]], dim=1)
    return demosaic_bilinear(planes)

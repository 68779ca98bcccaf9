"""Building blocks of the denoiser zoo, NCHW (NCDHW for the 3-D nets).

Counterpart of dprox_tpu/models/blocks.py (pixel (un)shuffle, replication
padding, the align-corners upsample, the 3x3 conv and the DRUNet blocks).
The JAX package runs NHWC; channel order of the (un)shuffle is the same,
c*r^2 + dy*r + dx, so flax checkpoints convert weight for weight. Module
attribute names follow the reference's torch zoo (KAIR's ``res`` of a
ResBlock), so a reference state dict loads with ``load_state_dict``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[N,C,H,W] -> [N,C*r^2,H/r,W/r], channel order c*r^2 + dy*r + dx."""
    return F.pixel_unshuffle(x, r)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of :func:`pixel_unshuffle`."""
    return F.pixel_shuffle(x, r)


def replication_pad_to_even(x: torch.Tensor, multiple: int = 2):
    """Pad H/W (edge mode) up to the next multiple; returns (x, h, w)."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x, h, w


def upsample_align_corners(x: torch.Tensor, axes: Sequence[int], factor: int = 2) -> torch.Tensor:
    """Linear upsample by ``factor`` along each of ``axes`` on torch's
    ``align_corners=True`` grid: output j reads source j (n-1)/(m-1), a
    gather of the two neighbours and a lerp in the JAX package's order
    (a length-1 axis is repeated)."""
    for axis in axes:
        n = x.shape[axis]
        m = n * factor
        if n == 1:
            x = torch.repeat_interleave(x, factor, dim=axis)
            continue
        pos = torch.arange(m, dtype=torch.float32, device=x.device) * ((n - 1) / (m - 1))
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.clamp(lo + 1, max=n - 1)
        shape = [1] * x.ndim
        shape[axis] = m
        w = (pos - lo).to(x.dtype).reshape(shape)
        x = torch.index_select(x, axis, lo) * (1 - w) + torch.index_select(x, axis, hi) * w
    return x


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "lrelu":
        return F.leaky_relu(x, 0.2)
    return x


class Conv(nn.Conv2d):
    """'same' convolution (padding dilation * (k - 1) / 2) with an optional
    ReLU or LeakyReLU(0.2) after it (cuDNN)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, bias: bool = True, act: str = ""):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=dilation * (kernel - 1) // 2, dilation=dilation, bias=bias)
        self.act = act

    def forward(self, x):
        return _act(super().forward(x), self.act)


class ResBlock(nn.Module):
    """Conv-ReLU-Conv residual block (DRUNet style, no bias); ``res`` as in
    the reference's KAIR ResBlock."""

    def __init__(self, features: int, bias: bool = False):
        super().__init__()
        self.res = nn.Sequential(Conv(features, features, bias=bias), nn.ReLU(),
                                 Conv(features, features, bias=bias))

    def forward(self, x):
        return x + self.res(x)


class DownStrideConv(nn.Conv2d):
    """2x2 stride-2 downsampling conv, no padding (DRUNet 'strideconv')."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = False):
        super().__init__(in_channels, out_channels, 2, stride=2, bias=bias)


class UpTransposeConv(nn.ConvTranspose2d):
    """2x2 stride-2 transpose conv (DRUNet 'convtranspose'): torch's true
    adjoint, so a flax ``nn.ConvTranspose`` kernel (HWIO, not transposed)
    comes over with its taps flipped and in/out swapped
    (``utils/checkpoint.py::convt_weight_from_flax``)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = False):
        super().__init__(in_channels, out_channels, 2, stride=2, bias=bias)

"""Deep-optics baseline U-Net, NCHW.

Counterpart of dprox_tpu/models/optics_unet.py: residual conv blocks (two
3x3 convs + LeakyReLU(0.01) with a 1x1-conv shortcut), stride-2 4x4 conv
downsampling, 2x2 transpose-conv upsampling with concatenated skips, and
circular padding to a multiple of 32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def pad_to_ratio_of_32(x: torch.Tensor) -> torch.Tensor:
    """Circular-pad NCHW input at the bottom and right so H and W are
    multiples of 32."""
    ph, pw = (-x.shape[-2]) % 32, (-x.shape[-1]) % 32
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="circular")
    return x


def unpad_from_ratio_of_32(x: torch.Tensor, shape) -> torch.Tensor:
    """Crop back to the original NCHW spatial shape."""
    return x[..., :shape[-2], :shape[-1]]


class OpticsConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.shortcut = nn.Conv2d(in_channels, features, 1)

    def forward(self, x):
        y = F.leaky_relu(self.conv1(x), 0.01)
        y = F.leaky_relu(self.conv2(y), 0.01)
        return y + self.shortcut(x)


class OpticsUNet(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3, base_features: int = 32):
        super().__init__()
        f = [base_features * 2 ** i for i in range(5)]
        self.enc = nn.ModuleList([OpticsConvBlock(in_channels, f[0])]
                                 + [OpticsConvBlock(f[i], f[i + 1]) for i in range(4)])
        self.down = nn.ModuleList([nn.Conv2d(f[i], f[i], 4, stride=2, padding=1)
                                   for i in range(4)])
        self.up = nn.ModuleList([nn.ConvTranspose2d(f[i + 1], f[i], 2, stride=2)
                                 for i in reversed(range(4))])
        self.dec = nn.ModuleList([OpticsConvBlock(2 * f[i], f[i]) for i in reversed(range(4))])
        self.out = nn.Conv2d(f[0], out_channels, 1)

    def forward(self, x):
        shape = x.shape
        x = pad_to_ratio_of_32(x)
        skips = [self.enc[0](x)]
        for down, enc in zip(self.down, self.enc[1:]):
            skips.append(enc(down(skips[-1])))
        d = skips.pop()
        for up, dec in zip(self.up, self.dec):
            d = dec(torch.cat([skips.pop(), up(d)], dim=1))
        return unpad_from_ratio_of_32(self.out(d), shape)

"""Small residual UNet denoiser (the CS-MRI 'unet-nm' prior), NCHW.

Counterpart of dprox_tpu/models/unet.py: a 32-512 channel encoder with
max-pool downs and 3-layer LeakyReLU(0.2) conv blocks, an align-corners
bilinear-upsample decoder with concatenated skips (the upsampled map
zero-padded to an odd-sized skip), and a residual output added to the
first ``out_channels`` channels of the input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv, upsample_align_corners


class ConvBlock(nn.Sequential):
    def __init__(self, in_channels: int, features: int, num_layer: int = 3):
        super().__init__(*[Conv(in_channels if i == 0 else features, features, act="lrelu")
                           for i in range(num_layer)])


class UNet(nn.Module):
    def __init__(self, in_channels: int = 2, out_channels: int = 1):
        super().__init__()
        self.out_channels = out_channels
        widths = [32, 64, 128, 256, 512]
        self.down = nn.ModuleList([ConvBlock(c_in, c) for c_in, c in
                                   zip([in_channels] + widths[:-1], widths)])
        # each up block takes the skip (c channels) and the upsampled map (2c)
        self.up = nn.ModuleList([ConvBlock(3 * c, c) for c in reversed(widths[:-1])])
        self.out = nn.Conv2d(widths[0], out_channels, 1)

    def forward(self, x):
        noisy = x
        skips = []
        for i, block in enumerate(self.down):
            x = block(F.max_pool2d(x, 2) if i else x)
            skips.append(x)
        x = skips.pop()
        for block in self.up:
            skip = skips.pop()
            x = upsample_align_corners(x, axes=(2, 3), factor=2)
            dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
            if dh or dw:
                x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            x = block(torch.cat([skip, x], dim=1))
        return noisy[:, :self.out_channels] + self.out(x)

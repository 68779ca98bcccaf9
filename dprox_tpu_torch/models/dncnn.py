"""DnCNN / FDnCNN / IRCNN denoisers, NCHW.

Counterpart of dprox_tpu/models/dncnn.py: plain conv stacks (BatchNorm
variants fold into the convs when a checkpoint is loaded,
``models/convert.py``). The stack is ``model``, convolutions at the even
indices and ReLUs between them, as in the reference's KAIR networks, so
their (folded) state dicts load by position.
"""
from __future__ import annotations

from torch import nn

from .blocks import Conv


def _stack(in_nc, out_nc, nc, dilations):
    layers, c = [], in_nc
    for d in dilations:
        layers += [Conv(c, nc, dilation=d), nn.ReLU()]
        c = nc
    return nn.Sequential(*layers, Conv(c, out_nc))


class DnCNN(nn.Module):
    """Residual denoiser: x - f(x)."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64, nb: int = 17):
        super().__init__()
        self.model = _stack(in_nc, out_nc, nc, [1] * (nb - 1))

    def forward(self, x):
        return x - self.model(x)


class FDnCNN(nn.Module):
    """Flexible DnCNN: the input carries a noise-level channel, direct output."""

    def __init__(self, in_nc: int = 2, out_nc: int = 1, nc: int = 64, nb: int = 20):
        super().__init__()
        self.model = _stack(in_nc, out_nc, nc, [1] * (nb - 1))

    def forward(self, x):
        return self.model(x)


class IRCNN(nn.Module):
    """7-layer dilated-conv residual denoiser, dilations 1,2,3,4,3,2,1."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64):
        super().__init__()
        self.model = _stack(in_nc, out_nc, nc, [1, 2, 3, 4, 3, 2])

    def forward(self, x):
        return x - self.model(x)

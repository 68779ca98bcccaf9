"""FFDNet denoisers (Zhang et al., TIP 2018) as ``nn.Module``s, NCHW.

Counterpart of dprox_tpu/models/ffdnet.py::FFDNet.__call__:
pixel-unshuffle (sf=2) -> concat noise-level map -> nb conv(+ReLU) stack
-> pixel-shuffle, with replication padding for odd sizes. The JAX
package's ``fused_apply`` is a TPU re-layout of the same function and has
no counterpart here; the convolutions run on cuDNN.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import Conv, pixel_shuffle, pixel_unshuffle, replication_pad_to_even


class FFDNet(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64,
                 nb: int = 15, residual: bool = False):
        super().__init__()
        self.in_nc, self.out_nc, self.nc, self.nb = in_nc, out_nc, nc, nb
        # residual=True predicts the noise and returns input - residual,
        # so sigma -> 0 degenerates to the identity
        self.residual = residual
        self.convs = nn.ModuleList(
            [Conv(in_nc * 4 + 1, nc)]
            + [Conv(nc, nc) for _ in range(nb - 2)]
            + [Conv(nc, out_nc * 4)])

    def forward(self, x: torch.Tensor, sigma) -> torch.Tensor:
        """x: [N,C,H,W]; sigma: scalar, [N] or [N,1,1,1] noise level."""
        x_in = x
        x, h, w = replication_pad_to_even(x, 2)
        x = pixel_unshuffle(x, 2)
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        m = torch.ones_like(x[:, :1]) * sigma.reshape(-1, 1, 1, 1)
        x = torch.cat([x, m], dim=1)  # the sigma map is the last channel
        for conv in self.convs[:-1]:
            x = torch.relu(conv(x))
        x = pixel_shuffle(self.convs[-1](x), 2)
        x = x[:, :, :h, :w]
        return x_in - x if self.residual else x


class FFDNet3D(nn.Module):
    """Hyperspectral variant of dprox_tpu/models/ffdnet.py::FFDNet3D: the
    caller concatenates the sigma map as the last of the ``in_nc``
    channels; no residual."""

    def __init__(self, in_nc: int = 32, out_nc: int = 31, nc: int = 64, nb: int = 15):
        super().__init__()
        self.convs = nn.ModuleList(
            [Conv(in_nc * 4, nc)] + [Conv(nc, nc) for _ in range(nb - 2)]
            + [Conv(nc, out_nc * 4)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, h, w = replication_pad_to_even(x, 2)
        x = pixel_unshuffle(x, 2)
        for conv in self.convs[:-1]:
            x = torch.relu(conv(x))
        return pixel_shuffle(self.convs[-1](x), 2)[:, :, :h, :w]

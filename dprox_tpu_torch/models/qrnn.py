"""QRNN3D / GRUNet hyperspectral denoisers, NCDHW (the band axis as depth).

Counterpart of dprox_tpu/models/qrnn.py. The QRNN "f-pooling" recurrence
along the band axis

    h_t = f_t * h_{t-1} + (1 - f_t) * z_t,    h_{-1} = 0

is a linear recurrence; the JAX package runs it as an associative scan,
here a doubling scan (ceil(log2 D) steps of a few elementwise ops), so
the sums are taken in another order than JAX's and agree to float32
rounding (1e-6 relative in the tests).

The reference's BatchNorm3d sits before each conv, so it cannot fold into
the conv exactly (the zero padding comes after the BN shift): ``bn=True``
modules carry the inference-mode BN affine as ``bn_scale`` / ``bn_shift``
per input channel. The decoder convs of ``QRNNREDC3D`` are stride-1
ConvTranspose3d upstream; here, as in the JAX package, they are plain
convs whose kernels a checkpoint conversion flips and transposes
(``models/convert.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .blocks import upsample_align_corners


def fpool_scan(z: torch.Tensor, f: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """f-pooling along dim 2 (the band axis of NCDHW); ``reverse`` runs it
    from the last band to the first."""
    if reverse:
        z, f = torch.flip(z, (2,)), torch.flip(f, (2,))
    a, b = f, (1.0 - f) * z
    shift, n = 1, z.shape[2]
    while shift < n:  # combine(earlier, later) = (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :, :shift], torch.addcmul(b[:, :, shift:], a[:, :, shift:],
                                                      b[:, :, :-shift])], 2)
        if 2 * shift < n:
            a = torch.cat([a[:, :, :shift], a[:, :, shift:] * a[:, :, :-shift]], 2)
        shift *= 2
    return torch.flip(b, (2,)) if reverse else b


class Conv3d(nn.Module):
    """Conv3d with padding k // 2 and no bias by default; ``bn`` puts the
    inference-mode BN affine before it (identity at initialization)."""

    def __init__(self, in_channels: int, features: int, k=(3, 3, 3), s=(1, 1, 1),
                 bias: bool = False, bn: bool = False):
        super().__init__()
        if bn:
            self.bn_scale = nn.Parameter(torch.ones(in_channels))
            self.bn_shift = nn.Parameter(torch.zeros(in_channels))
        self.bn = bn
        self.conv = nn.Conv3d(in_channels, features, tuple(k), stride=tuple(s),
                              padding=tuple(kk // 2 for kk in k), bias=bias)

    def pre(self, x):
        if not self.bn:
            return x
        return x * self.bn_scale.reshape(1, -1, 1, 1, 1) + self.bn_shift.reshape(1, -1, 1, 1, 1)

    def forward(self, x):
        return self.conv(self.pre(x))


class UpsampleConv3d(Conv3d):
    """(BN affine,) bilinear align-corners upsample by 2 of H and W, then
    the conv (torch's trilinear upsample with depth factor 1)."""

    def forward(self, x):
        return self.conv(upsample_align_corners(self.pre(x), axes=(3, 4), factor=2))


def _z(z, act):
    if act == "tanh":
        return torch.tanh(z)
    if act == "relu":
        return torch.relu(z)
    return z


class QRNNConv3D(nn.Module):
    """Single-direction QRNN layer; ``upsample=True`` upsamples H and W by 2
    before the gate conv."""

    def __init__(self, in_channels: int, hidden: int, k=(3, 3, 3), s=(1, 1, 1),
                 act: str = "tanh", upsample: bool = False, bn: bool = False):
        super().__init__()
        self.act = act
        cls = UpsampleConv3d if upsample else Conv3d
        self.conv = cls(in_channels, hidden * 2, k, (1, 1, 1) if upsample else s, bn=bn)

    def forward(self, x, reverse: bool = False):
        z, f = torch.chunk(self.conv(x), 2, dim=1)
        return fpool_scan(_z(z, self.act), torch.sigmoid(f), reverse)


class BiQRNNConv3D(nn.Module):
    """Bi-directional QRNN layer: one candidate, two forget gates."""

    def __init__(self, in_channels: int, hidden: int, k=(3, 3, 3), act: str = "tanh",
                 bias: bool = False, bn: bool = False):
        super().__init__()
        self.act = act
        self.conv = Conv3d(in_channels, hidden * 3, k, bias=bias, bn=bn)

    def forward(self, x):
        z, f1, f2 = torch.chunk(self.conv(x), 3, dim=1)
        z = _z(z, self.act)
        return fpool_scan(z, torch.sigmoid(f1)) + fpool_scan(z, torch.sigmoid(f2), reverse=True)


class ConvBlock(nn.Module):
    """Residual double-QRNN block with a 1x1x1 QRNN shortcut."""

    def __init__(self, in_ch: int, out_ch: int, bn: bool = False):
        super().__init__()
        self.conv1 = QRNNConv3D(in_ch, out_ch, bn=bn)
        self.conv2 = QRNNConv3D(out_ch, out_ch, bn=bn)
        self.shortcut = QRNNConv3D(in_ch, out_ch, k=(1, 1, 1), bn=bn)

    def forward(self, x, reverse: bool = False):
        r = self.conv2(self.conv1(x, reverse), reverse)
        return r + self.shortcut(x, reverse)


class GRUnet(nn.Module):
    """5-scale QRNN UNet; input NCDHW with C = in_ch (the signal and, with
    ``use_noise_map``, the noise map). Submodules carry the reference's
    names (models/convert.py::GRUNET_FORWARD_ORDER), registered in call
    order."""

    def __init__(self, in_ch: int = 1, out_ch: int = 1, use_noise_map: bool = False,
                 bn: bool = False, base: int = 16):
        super().__init__()
        self.use_noise_map = use_noise_map
        f = [base * 2 ** i for i in range(5)]
        self.Conv1 = BiQRNNConv3D(in_ch, f[0], bn=bn)
        for i in range(4):
            self.add_module(f"Down{i + 1}", QRNNConv3D(f[i], f[i], s=(1, 2, 2), bn=bn))
            self.add_module(f"Conv{i + 2}", ConvBlock(f[i], f[i + 1], bn=bn))
        for i in (4, 3, 2, 1):
            self.add_module(f"Up{i + 1}", QRNNConv3D(f[i], f[i - 1], upsample=True, bn=bn))
            self.add_module(f"Up_conv{i + 1}", ConvBlock(2 * f[i - 1], f[i - 1], bn=bn))
        self.Conv = BiQRNNConv3D(f[0], out_ch, bias=True, bn=bn)

    def forward(self, x):
        e = [self.Conv1(x)]
        for i in range(4):
            d = getattr(self, f"Down{i + 1}")(e[-1], reverse=True)
            e.append(getattr(self, f"Conv{i + 2}")(d))
        d = e.pop()
        for i in (4, 3, 2, 1):
            d = getattr(self, f"Up{i + 1}")(d, reverse=True)
            d = getattr(self, f"Up_conv{i + 1}")(torch.cat([e.pop(), d], 1))
        out = self.Conv(d)
        return out + (x[:, :1] if self.use_noise_map else x)


class QRNNREDC3D(nn.Module):
    """QRNN3D encoder-decoder with the reference's skip wiring and config
    axes (``sample_idx``, ``has_ad``, ``plain``, ``is_2d``)."""

    def __init__(self, in_channels: int = 1, channels: int = 16, num_half_layer: int = 5,
                 sample_idx: Sequence[int] = (1, 3), has_ad: bool = True, plain: bool = False,
                 is_2d: bool = False, act: str = "tanh", bn: bool = True):
        super().__init__()
        k = (1, 3, 3) if is_2d else (3, 3, 3)
        down = (1, 1, 1) if plain else (1, 2, 2)
        self.num_half_layer, self.has_ad = num_half_layer, has_ad
        self.feature_extractor = BiQRNNConv3D(in_channels, channels, k=k, act=act, bn=bn)
        enc, ch = [], channels
        for i in range(num_half_layer):
            if i in sample_idx:
                enc.append(QRNNConv3D(ch, ch * 2, k=k, s=down, act=act, bn=bn))
                ch *= 2
            else:
                enc.append(QRNNConv3D(ch, ch, k=k, act=act, bn=bn))
        dec = []
        for i in reversed(range(num_half_layer)):
            if i in sample_idx:
                dec.append(QRNNConv3D(ch, ch // 2, k=k, act=act, bn=bn,
                                      upsample=not plain))
                ch //= 2
            else:
                dec.append(QRNNConv3D(ch, ch, k=k, act=act, bn=bn))
        self.encoder = nn.ModuleList(enc)
        self.decoder = nn.ModuleList(dec)
        self.reconstructor = BiQRNNConv3D(channels, 1, k=k, bias=True,
                                          act="none" if act == "relu" else act, bn=bn)

    def forward(self, x):
        out = self.feature_extractor(x)
        xs, reverse = [out], False
        for layer in self.encoder:
            out = layer(out, reverse)
            xs.append(out)
            reverse = reverse != self.has_ad
        xs.pop()
        for layer in self.decoder:
            out = layer(out, reverse) + xs.pop()
            reverse = reverse != self.has_ad
        return self.reconstructor(out) + x[:, :1]

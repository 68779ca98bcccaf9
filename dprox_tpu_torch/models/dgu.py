"""DGUNet-style proximal network for unrolled solvers, NCHW.

Counterpart of dprox_tpu/models/dgu.py: a multi-stage UNet whose prox
step depends on the unrolling depth. Stage 0 runs a first-stage
encoder/decoder, middle stages a cross-stage-feature-fusion (CSFF)
encoder conditioned on the previous stage's features, and the last stage
a shallow tail. The cross-stage context is an explicit carry
``(encoder features, decoder features, SAM features)`` returned by
``first``/``middle`` and passed back in, as in the JAX package.

Attribute names are the reference's torch names (the keys of
dprox_tpu/models/dgu.py::_DGU_TOP and the layout ``_dgu_rewrite_key``
reads), so a reference DGUNet state dict loads with ``load_state_dict``.
The SAM image branch and the tail start at zero, as in the JAX package:
the untrained unrolled solver is then stable.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _conv(in_ch, out_ch, k=3, bias=False, stride=1):
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=bias)


def _zero(conv: nn.Conv2d) -> nn.Conv2d:
    nn.init.zeros_(conv.weight)
    return conv


class CALayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.conv_du = nn.Sequential(_conv(channel, channel // reduction, 1), nn.ReLU(),
                                     _conv(channel // reduction, channel, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(torch.mean(x, dim=(2, 3), keepdim=True))


class CAB(nn.Module):
    def __init__(self, n_feat: int, reduction: int = 4):
        super().__init__()
        self.body = nn.Sequential(_conv(n_feat, n_feat), nn.PReLU(), _conv(n_feat, n_feat))
        self.CA = CALayer(n_feat, reduction)

    def forward(self, x):
        return x + self.CA(self.body(x))


class SAM(nn.Module):
    """Supervised attention module: features and the stage's image."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.conv1 = _conv(n_feat, n_feat, 1)
        self.conv2 = _zero(_conv(n_feat, 3, 1))

    def forward(self, x, x_img):
        return self.conv1(x) + x, self.conv2(x) + x_img


class HalfInstanceNorm(nn.Module):
    """Affine instance norm of the first half of the channels, epsilon
    1e-5 (the JAX package's expression, in its order)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, out):
        half = self.weight.shape[0]
        o1, o2 = out[:, :half], out[:, half:]
        mu = torch.mean(o1, dim=(2, 3), keepdim=True)
        var = torch.mean((o1 - mu) ** 2, dim=(2, 3), keepdim=True)
        o1 = ((o1 - mu) / torch.sqrt(var + 1e-5) * self.weight.reshape(1, -1, 1, 1)
              + self.bias.reshape(1, -1, 1, 1))
        return torch.cat([o1, o2], 1)


class HINBlock(nn.Module):
    """UNetConvBlock: half-instance-norm conv block (``use_hin`` in the
    encoder only), a CSFF fusion where ``use_csff`` and the block
    downsamples, and a 4x4 stride-2 downsample."""

    def __init__(self, in_size: int, out_size: int, downsample: bool, use_csff: bool = False,
                 use_hin: bool = True):
        super().__init__()
        self.downsample_ = downsample
        self.conv_1 = nn.Conv2d(in_size, out_size, 3, padding=1)
        if use_hin:
            self.norm = HalfInstanceNorm(out_size // 2)
        self.use_hin = use_hin
        self.conv_2 = nn.Conv2d(out_size, out_size, 3, padding=1)
        self.identity = nn.Conv2d(in_size, out_size, 1)
        if downsample and use_csff:
            self.csff_enc = nn.Conv2d(out_size, out_size, 3, padding=1)
            self.csff_dec = nn.Conv2d(in_size, out_size, 3, padding=1)
            self.phi = nn.Conv2d(out_size, out_size, 3, padding=1)
            self.gamma = nn.Conv2d(out_size, out_size, 3, padding=1)
        if downsample:
            self.downsample = nn.Conv2d(out_size, out_size, 4, stride=2, padding=1, bias=False)

    def forward(self, x, enc=None, dec=None):
        out = self.conv_1(x)
        if self.use_hin:
            out = self.norm(out)
        out = F.leaky_relu(out, 0.2)
        out = F.leaky_relu(self.conv_2(out), 0.2)
        out = out + self.identity(x)
        if enc is not None and dec is not None:
            skip = F.leaky_relu(self.csff_enc(enc) + self.csff_dec(dec), 0.1)
            out = out * torch.sigmoid(self.phi(skip)) + self.gamma(skip) + out
        if self.downsample_:
            return self.downsample(out), out
        return out


class Encoder(nn.Module):
    def __init__(self, n_feat: int, scale: int, depth: int = 4, csff: bool = False):
        super().__init__()
        self.body = nn.ModuleList(
            [HINBlock(n_feat + scale * i, n_feat + scale * (i + 1), True, csff)
             for i in range(depth - 1)]
            + [HINBlock(n_feat + scale * (depth - 1), n_feat + scale * (depth - 1), False,
                        csff)])

    def forward(self, x, encoder_outs=None, decoder_outs=None):
        res = []
        for i, blk in enumerate(self.body[:-1]):
            if encoder_outs is not None and decoder_outs is not None:
                x, x_up = blk(x, encoder_outs[i], decoder_outs[-i - 1])
            else:
                x, x_up = blk(x)
            res.append(x_up)
        return res, self.body[-1](x)


class UNetUpBlock(nn.Module):
    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_size, out_size, 2, stride=2)
        # the decoder's conv blocks have no half-instance norm
        self.conv_block = HINBlock(2 * out_size, out_size, False, use_hin=False)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.up(x), skip], 1))


class Decoder(nn.Module):
    def __init__(self, n_feat: int, scale: int, depth: int = 4):
        super().__init__()
        sizes = [n_feat + scale * (depth - i - 2) for i in range(depth - 1)]
        self.body = nn.ModuleList([UNetUpBlock(s + scale, s) for s in sizes])
        self.skip_conv = nn.ModuleList([nn.Conv2d(s + scale, s, 3, padding=1) for s in sizes])

    def forward(self, x, bridges):
        res = []
        for i, (up, skip_conv) in enumerate(zip(self.body, self.skip_conv)):
            x = up(x, skip_conv(bridges[-i - 1]))
            res.append(x)
        return res


class MergeBlock(nn.Module):
    """Subspace-projection merge of the previous stage's features."""

    def __init__(self, n_feat: int, subspace_dim: int = 16):
        super().__init__()
        self.subnet = nn.Conv2d(2 * n_feat, subspace_dim, 3, padding=1)
        self.conv_block = nn.Conv2d(2 * n_feat, n_feat, 3, padding=1)

    def forward(self, x, bridge):
        b, c, h, w = bridge.shape
        sub = self.subnet(torch.cat([x, bridge], 1))
        V_t = sub.reshape(b, -1, h * w)
        V_t = V_t / (1e-6 + torch.abs(V_t).sum(dim=2, keepdim=True))
        V = V_t.transpose(1, 2)
        project_mat = torch.linalg.inv(V_t @ V) @ V_t
        bridge_flat = bridge.reshape(b, c, h * w).transpose(1, 2)
        bridge_new = (V @ (project_mat @ bridge_flat)).transpose(1, 2).reshape(b, c, h, w)
        return self.conv_block(torch.cat([x, bridge_new], 1)) + x


class BasicBlock(nn.Module):
    """The middle stages' shared block (the reference's ``basic``)."""

    def __init__(self, nf, scale_unetfeats, reduction):
        super().__init__()
        self.shallow_feat2 = nn.Sequential(_conv(3, nf), CAB(nf, reduction))
        self.merge12 = MergeBlock(nf)
        self.stage2_encoder = Encoder(nf, scale_unetfeats, depth=4, csff=True)
        self.stage2_decoder = Decoder(nf, scale_unetfeats, depth=4)
        self.sam23 = SAM(nf)


Carry = Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]


class DGUDenoiser(nn.Module):
    """Step-indexed proximal network with an explicit carry:
    ``first(v) -> (x, carry)``, ``middle(v, carry) -> (x, carry)``,
    ``last(v, carry) -> x``; ``forward`` runs the three in turn."""

    def __init__(self, n_feat: int = 40, scale_unetfeats: int = 20, scale_orsnetfeats: int = 16,
                 reduction: int = 4):
        super().__init__()
        nf = n_feat
        self.shallow_feat1 = nn.Sequential(_conv(3, nf), CAB(nf, reduction))
        self.stage1_encoder = Encoder(nf, scale_unetfeats, depth=4, csff=False)
        self.stage1_decoder = Decoder(nf, scale_unetfeats, depth=4)
        self.sam12 = SAM(nf)
        self.basic = BasicBlock(nf, scale_unetfeats, reduction)
        self.shallow_feat7 = nn.Sequential(_conv(3, nf), CAB(nf, reduction))
        self.concat67 = _conv(2 * nf, nf + scale_orsnetfeats)
        self.tail = _zero(_conv(nf + scale_orsnetfeats, 3))

    def first(self, v) -> Tuple[torch.Tensor, Carry]:
        feat1, fin1 = self.stage1_encoder(self.shallow_feat1(v))
        res1 = self.stage1_decoder(fin1, feat1)
        samfeats, x = self.sam12(res1[-1], v)
        return x, (feat1, res1, samfeats)

    def middle(self, v, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        feat1, res1, samfeats = carry
        b = self.basic
        x2 = b.merge12(b.shallow_feat2(v), samfeats)
        feat2, fin2 = b.stage2_encoder(x2, feat1, res1)
        res2 = b.stage2_decoder(fin2, feat2)
        samfeats2, x = b.sam23(res2[-1], v)
        return x, (feat2, res2, samfeats2)

    def last(self, v, carry: Carry) -> torch.Tensor:
        x7 = self.concat67(torch.cat([self.shallow_feat7(v), carry[2]], 1))
        return self.tail(x7)

    def forward(self, v, stage: str = "all", carry: Optional[Carry] = None):
        """``stage``: "first", "middle", "last" (one stage, as the methods
        of the same names) or "all" (the three in turn)."""
        if stage == "first":
            return self.first(v)
        if stage == "middle":
            return self.middle(v, carry)
        if stage == "last":
            return self.last(v, carry)
        x, carry = self.first(v)
        x, carry = self.middle(x, carry)
        return self.last(x, carry)

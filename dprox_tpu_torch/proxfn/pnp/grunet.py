"""GRUNet / QRNN3D hyperspectral denoiser wrappers.

Counterpart of dprox_tpu/proxfn/pnp/grunet.py. Inputs are [B, Bands, H,
W]; the 3-D recurrent nets take NCDHW with the band axis as depth and the
signal and its noise map as the two channels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...models.convert import GRUNET_FORWARD_ORDER, qrnn_state_dict
from ...models.qrnn import GRUnet, QRNNREDC3D
from ...utils.checkpoint import grunet_state_dict_from_flax, qrnn3d_state_dict_from_flax
from .denoisers import TVDenoiser, _NetDenoiser


def _ncdhw_with_map(x, sigma):
    """[B, Bands, H, W] -> [B, 2, Bands, H, W]: the signal and a sigma map."""
    v = x[:, None]
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1, 1, 1, 1, 1)
    return torch.cat([v, torch.ones_like(v) * sigma], dim=1)


class GRUNetDenoiser(_NetDenoiser):
    """GRUnet with a noise map, no BN (the reference's shipped checkpoint is
    the nobn variant); ``base`` 8 and 12 are the in-repo-trained nets."""

    def __init__(self, params=None, ckpt_path: Optional[str] = None, base: int = 16):
        self._setup(lambda: GRUnet(in_ch=2, out_ch=1, use_noise_map=True, bn=False, base=base),
                    params, ckpt_path, grunet_state_dict_from_flax,
                    from_torch=lambda sd, m: qrnn_state_dict(sd, m, GRUNET_FORWARD_ORDER))

    def denoise(self, x, sigma, params=None):
        return self._net(params, _ncdhw_with_map(x, sigma))[:, 0]


class QRNN3DDenoiser(_NetDenoiser):
    """QRNNREDC3D (BN before each conv, as the reference's checkpoints)."""

    def __init__(self, params=None, ckpt_path: Optional[str] = None,
                 use_noise_map: bool = True):
        self.use_noise_map = use_noise_map
        self._setup(lambda: QRNNREDC3D(in_channels=2 if use_noise_map else 1), params,
                    ckpt_path, qrnn3d_state_dict_from_flax, from_torch=qrnn_state_dict)

    def denoise(self, x, sigma, params=None):
        inp = _ncdhw_with_map(x, sigma) if self.use_noise_map else x[:, None]
        return self._net(params, inp)[:, 0]


class GRUNetTVDenoiser(GRUNetDenoiser):
    """weight * GRUNet + (1 - weight) * TV, TV at 255 sigma (2-D per band
    through the TV kernel on [B * Bands, H, W], or 3-D with
    ``use_3dtv``)."""

    def __init__(self, params=None, ckpt_path: Optional[str] = None, base: int = 16,
                 weight: float = 0.5, use_3dtv: bool = False):
        super().__init__(params, ckpt_path, base=base)
        self.weight = weight
        self.tv = TVDenoiser(use_3dtv=use_3dtv)

    def denoise(self, x, sigma, params=None):
        x1 = super().denoise(x, sigma, params)
        x2 = self.tv.denoise(x, torch.as_tensor(sigma, device=x.device) * 255.0)
        return self.weight * x1 + (1.0 - self.weight) * x2

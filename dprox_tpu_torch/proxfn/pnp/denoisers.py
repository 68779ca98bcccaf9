"""Denoiser wrappers: a uniform ``denoise(x, sigma)`` on BCHW tensors.

Counterpart of dprox_tpu/proxfn/pnp/denoisers.py (FFDNetColorDenoiser,
TVDenoiser, DeepTVDenoiser). The 2-D TV branch always goes through the
fused TV kernel wrapper (ops/kernels.py::tv_denoise_chw), which launches
the CUDA kernel for CUDA tensors and runs its plain version for CPU ones.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...models import FFDNet
from ...ops.kernels import tv_denoise_chw
from ...utils.checkpoint import ffdnet_state_dict_from_flax, load_flax_msgpack


class Denoiser:
    """Base wrapper."""

    def to(self, device) -> "Denoiser":
        return self

    def denoise(self, x: torch.Tensor, sigma) -> torch.Tensor:
        """x: [B,C,H,W]; sigma: tensor holding one noise level."""
        raise NotImplementedError

    def __call__(self, x, sigma):
        return self.denoise(x, sigma)


class FFDNetColorDenoiser(Denoiser):
    """Color FFDNet; weights from a flax msgpack checkpoint. The network is
    frozen (no gradients) and in eval mode."""

    def __init__(self, ckpt_path: Optional[str] = None, nc: int = 96,
                 nb: int = 12, residual: bool = False):
        self.module = FFDNet(in_nc=3, out_nc=3, nc=nc, nb=nb, residual=residual)
        if ckpt_path is not None:
            sd = ffdnet_state_dict_from_flax(load_flax_msgpack(ckpt_path))
            self.module.load_state_dict(sd)
        self.module.requires_grad_(False).eval()

    def to(self, device):
        self.module.to(device)
        return self

    def denoise(self, x, sigma):
        return self.module(x, sigma)


class TVDenoiser(Denoiser):
    """2-D TV per band through the fused TV kernel."""

    def __init__(self, iter_num: int = 5):
        self.iter_num = iter_num

    def denoise(self, x, sigma):
        B, C, H, W = x.shape
        lam = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1)
        out = tv_denoise_chw(x.reshape(B * C, H, W).contiguous(), lam, self.iter_num)
        return out.reshape(B, C, H, W)


class DeepTVDenoiser(Denoiser):
    """Weighted fusion of a deep denoiser and TV outputs.

    ``weight``: a float fixes w; None computes the least-squares fusion
    weight minimizing ||w*d + (1-w)*t - x||^2 in closed form.
    """

    def __init__(self, deep_denoiser: Denoiser, tv_iter: int = 10,
                 weight: Optional[float] = None):
        self.deep = deep_denoiser
        self.tv = TVDenoiser(iter_num=tv_iter)
        self.weight = weight

    def to(self, device):
        self.deep.to(device)
        return self

    def denoise(self, x, sigma):
        d = self.deep.denoise(x, sigma)
        t = self.tv.denoise(x, sigma)
        if self.weight is not None:
            return self.weight * d + (1 - self.weight) * t
        num = torch.sum((x - t) * (d - t))
        den = torch.sum((d - t) ** 2) + 1e-12
        w = num / den
        w = torch.minimum(torch.maximum(w, w.new_zeros(())), w.new_ones(()))
        return w * d + (1 - w) * t


"""TV denoising by dual ascent on [..., H, W] stacks (bands leading).

Counterpart of dprox_tpu/models/tv.py (``tv_denoising_chw``,
``tv_denoising3d_chw`` and the [H, W, B] forms ``tv_denoising``,
``tv_denoising3d``), in the same operation order. The 2-D CHW function is
the plain version of the fused TV kernel (ops/kernels.py::tv_denoise_chw),
which callers use instead, as ``tv_denoising`` does; 3-D TV has no kernel.
"""
from __future__ import annotations

import torch


def _clip(x, t):
    return torch.minimum(torch.maximum(x, -t), t)


def _dh_w(x):  # horizontal diffs along W
    return x[..., 1:] - x[..., :-1]


def _dv_w(x):
    return x[..., 1:, :] - x[..., :-1, :]


def _dht_w(z):
    return torch.cat([-z[..., :1], z[..., :-1] - z[..., 1:], z[..., -1:]], -1)


def _dvt_w(z):
    return torch.cat([-z[..., :1, :], z[..., :-1, :] - z[..., 1:, :], z[..., -1:, :]], -2)


def _db_w(x):  # band diffs (the band axis, -3)
    return x[..., 1:, :, :] - x[..., :-1, :, :]


def _dbt_w(z):
    return torch.cat([-z[..., :1, :, :], z[..., :-1, :, :] - z[..., 1:, :, :],
                      z[..., -1:, :, :]], -3)


def _lam(lam, y0):
    lam = torch.as_tensor(lam, dtype=y0.dtype, device=y0.device)
    if lam.numel() > 1:
        return lam.reshape((-1,) + (1,) * (y0.ndim - 1))
    return lam.reshape(())


def tv_denoising_chw(y0: torch.Tensor, lam, iterations: int = 100) -> torch.Tensor:
    """2-D TV (per band) on [B, H, W]; ``lam`` is a float, or a tensor
    holding one value or one per band."""
    alpha = 5.0
    t = _lam(lam, y0) / 2.0
    zh = torch.zeros_like(y0[..., 1:])
    zv = torch.zeros_like(y0[..., 1:, :])
    x0 = y0
    for _ in range(iterations):
        x0h = y0 - _dht_w(zh)
        x0v = y0 - _dvt_w(zv)
        x0 = (x0h + x0v) / 2.0
        zh = _clip(zh + (1.0 / alpha) * _dh_w(x0), t)
        zv = _clip(zv + (1.0 / alpha) * _dv_w(x0), t)
    return x0


def tv_denoising3d_chw(y0: torch.Tensor, lam, iterations: int = 100) -> torch.Tensor:
    """3-D TV with a band-difference term on [C, H, W], or on [B, C, H, W]
    image by image; ``lam`` is a float or a tensor broadcastable to y0."""
    alpha = 5.0
    t = torch.as_tensor(lam, dtype=y0.dtype, device=y0.device) / 2.0
    zh = torch.zeros_like(y0[..., 1:])
    zv = torch.zeros_like(y0[..., 1:, :])
    zt = torch.zeros_like(y0[..., 1:, :, :])
    x0 = y0
    for _ in range(iterations):
        x0h = y0 - _dht_w(zh)
        x0v = y0 - _dvt_w(zv)
        x0t = y0 - _dbt_w(zt)
        x0 = (x0h + x0v + x0t) / 3.0
        zh = _clip(zh + (1.0 / alpha) * _dh_w(x0), t)
        zv = _clip(zv + (1.0 / alpha) * _dv_w(x0), t)
        zt = _clip(zt + (1.0 / alpha) * _db_w(x0), t)
    return x0


def tv_denoising(y0: torch.Tensor, lam, iterations: int = 100) -> torch.Tensor:
    """2-D TV per band on [H, W, B], through ``ops.kernels.tv_denoise_chw``
    (the TV kernel on a CUDA tensor, which takes at most
    ``kernels.tv_max_iterations()`` iterations, and raises beyond; the
    plain version on a CPU tensor); ``lam`` is a float or a tensor of one
    value."""
    from ..ops.kernels import tv_denoise_chw

    lam = torch.as_tensor(lam, dtype=torch.float32, device=y0.device).reshape(())
    out = tv_denoise_chw(y0.permute(2, 0, 1).contiguous(), lam, iterations)
    return out.permute(1, 2, 0)


def tv_denoising3d(y0: torch.Tensor, lam, iterations: int = 100) -> torch.Tensor:
    """3-D TV with a band-difference term on [H, W, B]."""
    return tv_denoising3d_chw(y0.permute(2, 0, 1), lam, iterations).permute(1, 2, 0)

"""Non-local-means prior (shift-stack implementation).

Counterpart of dprox_tpu/proxfn/nlm.py: the "fast" NLM denoiser built
from rolled shift-stacks and box-filter sums, as plain PyTorch (the JAX
package leaves it to XLA too; it has no kernel). A call is a loop of
small elementwise launches: (search window)^2 shifts, each with a
(patch)^2-term box sum.
"""
from __future__ import annotations

import torch

from ..utils.misc import safe_sqrt
from .base import ProxFn

EPSILON = 1e-6


def rgb_to_luminance(rgb):
    return 0.299 * rgb[:, :1] + 0.587 * rgb[:, 1:2] + 0.114 * rgb[:, 2:3]


def _box_sum(t, patch_size: int):
    r = patch_size // 2
    out = torch.zeros_like(t)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out = out + torch.roll(t, (dy, dx), dims=(2, 3))
    return out


def nlm_denoise(rgb, sigma, search_window_size: int = 11, patch_size: int = 5):
    """[B, 3, H, W] in [0, 1]; weights from patch distances of the
    luminance, filter strength h = 2 sigma; the result clipped to [0, 1]."""
    h = torch.as_tensor(sigma, dtype=rgb.dtype, device=rgb.device) * 2.0
    y = rgb_to_luminance(rgb)
    r = search_window_size // 2
    num = torch.zeros_like(rgb)
    den = torch.zeros_like(y)
    scale = torch.maximum(h, h.new_zeros(())) + EPSILON
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted_rgb = torch.roll(rgb, (dy, dx), dims=(2, 3))
            shifted_y = torch.roll(y, (dy, dx), dims=(2, 3))
            dist = torch.sqrt(_box_sum((y - shifted_y) ** 2, patch_size))
            w = torch.exp(-dist / scale)
            num = num + shifted_rgb * w
            den = den + w
    out = num / den
    return torch.minimum(torch.maximum(out, out.new_zeros(())), out.new_ones(()))


class patch_nlm(ProxFn):
    def __init__(self, linop, search_window_size: int = 11, patch_size: int = 5):
        super().__init__(linop)
        self.search_window_size = search_window_size
        self.patch_size = patch_size

    def _prox(self, v, lam, params=None, step=None):
        return nlm_denoise(v, safe_sqrt(lam), self.search_window_size, self.patch_size)

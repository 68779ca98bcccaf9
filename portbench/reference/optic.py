"""The plain reference of the DOE co-design training step, in plain PyTorch.

One step of Delta-Prox's end-to-end optics co-design (SIGGRAPH 2023,
examples/papers/deltaprox_siggraph_2023/computional_optics/
e2e_optics_dprox.py, ``step_fn``): a height map becomes a phase profile
for each wavelength; the aperture cuts it; Fresnel propagation by the
transfer function on a grid padded by a quarter on each side gives the
field at the sensor, whose |field|^2, block-averaged to the patch and
normalised to sum 1, is the PSF. The measurement is the image convolved
circularly with the PSF plus Gaussian noise; ADMM reconstructs it through
the frequency x-update (``solvers.freq_xupdate``) with 0.5 FFDNet + 0.5 TV
as the prior; the loss is the MSE against the image, and its gradient
with respect to the height map and the log schedules comes from
autograd. Nothing here imports the port.

Departures from the source, each where the port departs the same way:

* ``phase_scale`` (wave number times (n - 1)) is computed in float64 and
  rounded to float32 before it multiplies the squared height map; the
  propagator's transfer function takes its frequency grid in float32 and
  its phase in float64, rounded to complex64. The source builds both in
  float32 torch.
* The prior is the repo's ``res_ffdnet_color_tv`` (FFDNet 96 wide, 10
  deep, a residual head, fused 0.5 with 10 TV iterations); the source's
  is ``ffdnet_color`` (12 deep, no residual head, no TV).
* The schedule is the repo's hand schedule (rho = geomspace(0.3, 0.03),
  sigma from log_descent(80, 30)); the source's is log_descent(49, 7.65).

As in the source, the PSF's OTF shifts every axis of the [1, C, h, w]
PSF (``torch.fft.ifftshift`` with no dims), so colour c is blurred by
the PSF of colour (c + 1) mod C.

The height map the step starts from is an input, as the images are: the
benchmark hands both sides the port's Fresnel-lens height map.

``CoDesign.step`` computes the gradient one image at a time and sums
(``per_image=True``), so that a batch fits beside what a run keeps: the
loss is a mean over the batch and the PSF is shared, so the sum is the
batch's gradient. ``control=True`` runs the network in bfloat16.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import ops, solvers

Tensor = torch.Tensor


def coordinates(n: int, dx: float) -> Tuple[np.ndarray, np.ndarray]:
    """Centred sample positions of an n x n grid of pitch ``dx``, two
    float32 [n, n] arrays (rows, columns)."""
    x = ((np.arange(n) - (n - 1) / 2.0) * dx).astype(np.float32)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    return xx, yy


class Optic:
    """The PSF of a height map: ``psf(height_map_sqrt)`` -> [1, C, patch,
    patch] float32, summing to 1, differentiable in the height map."""

    def __init__(self, patch: int, grid: int, dx: float, distance: float,
                 wave_lengths: Sequence[float], refractive_idcs: Sequence[float], device):
        if grid % patch:
            raise ValueError(f"the wave grid {grid} must be a multiple of the patch {patch}")
        self.patch, self.pad = patch, grid // 4
        xx, yy = coordinates(grid, dx)
        r = np.sqrt(xx ** 2 + yy ** 2)
        self.aperture = torch.from_numpy((r < xx.max()).astype(np.float32))[None, None].to(device)
        lam = np.asarray(wave_lengths, np.float64).reshape(1, -1, 1, 1)
        dn = np.asarray(refractive_idcs, np.float64).reshape(1, -1, 1, 1) - 1.0
        self.phase_scale = torch.from_numpy((2 * np.pi / lam * dn).astype(np.float32)).to(device)
        m = grid + 2 * self.pad
        f = np.fft.ifftshift((np.arange(m) - (m - 1) / 2.0).astype(np.float32)
                             / np.float32(dx * m))
        fy, fx = np.meshgrid(f, f, indexing="ij")
        phase = -np.pi * distance * lam * (fx ** 2 + fy ** 2)[None, None]
        self.H = torch.from_numpy(np.exp(1j * phase).astype(np.complex64)).to(device)

    def psf(self, height_map_sqrt: Tensor) -> Tensor:
        phase = self.phase_scale * height_map_sqrt ** 2
        field = self.aperture * torch.polar(torch.ones_like(phase), phase)
        p = self.pad
        out = torch.fft.ifft2(torch.fft.fft2(F.pad(field, (p, p, p, p))) * self.H)[..., p:-p, p:-p]
        intensity = out.abs() ** 2
        b, c, n, _ = intensity.shape
        f = n // self.patch
        psf = intensity.reshape(b, c, self.patch, f, self.patch, f).mean(dim=(3, 5))
        return psf / psf.sum()


def otf(psf: Tensor) -> Tensor:
    """The OTF of a [1, C, h, w] PSF on an h x w image: every axis shifted
    so the centre sits at the origin (the source's ``ifftshift`` with no
    dims), then the 2-D FFT."""
    return torch.fft.fft2(torch.fft.ifftshift(psf))


def img_psf_conv(img: Tensor, psf: Tensor) -> Tensor:
    """Circular convolution of [N, C, h, w] images with a [1, C, h, w] PSF."""
    return torch.fft.ifft2(torch.fft.fft2(img) * otf(psf)).real


class CoDesign:
    """The step's prior, schedule and noise around an ``Optic``.

    ``weights``: FFDNet's tensors (``convs.i.weight``, ``convs.i.bias``);
    ``layers``, ``residual``: its depth and head; ``deep_weight``: FFDNet's
    share of the fused prior, TV's the rest, with ``tv_iterations``;
    ``noise_sigma``: the measurement noise's standard deviation."""

    def __init__(self, optic: Optic, weights: Dict[str, Tensor], layers: int, residual: bool,
                 deep_weight: float, tv_iterations: int, noise_sigma: float):
        self.optic, self.weights = optic, weights
        self.weights_bf16 = {k: v.to(torch.bfloat16) for k, v in weights.items()}
        self.layers, self.residual = layers, residual
        self.deep_weight, self.tv_iterations = deep_weight, tv_iterations
        self.noise_sigma = noise_sigma

    def prior(self, v: Tensor, lam: Tensor, control: bool = False) -> Tensor:
        if control:
            d = ops.ffdnet(self.weights_bf16, v.to(torch.bfloat16), lam.to(torch.bfloat16),
                           self.layers, self.residual).float()
        else:
            d = ops.ffdnet(self.weights, v, lam, self.layers, self.residual)
        h, w = v.shape[-2:]
        t = ops.tv_denoise(v.reshape(-1, h, w), lam, self.tv_iterations).reshape(v.shape)
        return self.deep_weight * d + (1 - self.deep_weight) * t

    def loss(self, psf: Tensor, log_rhos: Tensor, log_sigmas: Tensor, gt: Tensor,
             noise: Tensor, control: bool = False) -> Tensor:
        """mean((x - gt)^2) of the reconstruction x of ``gt`` seen through
        ``psf`` with ``noise`` (standard normal, scaled here)."""
        y = img_psf_conv(gt, psf) + self.noise_sigma * noise
        H = otf(psf)
        update = solvers.freq_xupdate(torch.conj(H) * torch.fft.fft2(y),
                                      torch.abs(torch.conj(H) * H))
        x = solvers.admm(y, torch.exp(log_rhos), torch.exp(log_sigmas), update,
                         lambda v, lam: self.prior(v, lam, control))
        return torch.mean((x - gt) ** 2)

    def step(self, height_map_sqrt: Tensor, log_rhos: Tensor, log_sigmas: Tensor, gt: Tensor,
             noise: Tensor, control: bool = False, per_image: bool = True
             ) -> Tuple[Tensor, Tuple[Tensor, Tensor, Tensor]]:
        """(the loss, its gradients with respect to the height map, the log
        rhos and the log sigmas) on the batch ``gt`` [N, C, h, w] with its
        ``noise``, in float32 with TF32 off (the network in bfloat16 under
        ``control``). ``per_image`` differentiates one image at a time
        against the shared PSF and sums; otherwise the whole batch at once."""
        with ops.tf32(False), torch.enable_grad():
            hm = height_map_sqrt.detach().requires_grad_(True)
            lr = log_rhos.detach().requires_grad_(True)
            ls = log_sigmas.detach().requires_grad_(True)
            psf = self.optic.psf(hm)
            held = psf.detach().requires_grad_(True)
            n = gt.shape[0]
            parts = [slice(i, i + 1) for i in range(n)] if per_image else [slice(0, n)]
            loss, g_psf, g_lr, g_ls = 0.0, 0.0, 0.0, 0.0
            for part in parts:
                share = self.loss(held, lr, ls, gt[part], noise[part], control)
                share = share * ((part.stop - part.start) / n)
                gp, gr, gs = torch.autograd.grad(share, (held, lr, ls))
                loss, g_psf = loss + share.detach(), g_psf + gp
                g_lr, g_ls = g_lr + gr, g_ls + gs
            (g_hm,) = torch.autograd.grad(psf, hm, g_psf)
        return loss, (g_hm, g_lr, g_ls)

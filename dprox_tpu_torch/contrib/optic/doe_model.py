"""DOE (diffractive optical element) physics for end-to-end optics co-design.

Counterpart of dprox_tpu/contrib/optic/doe_model.py. The constants (the
Fresnel lens, the propagator's transfer function H, the coordinates) are
made on the host in numpy, in the JAX package's order and precision, and
kept as buffers of the ``nn.Module``s on their device; the learnable
height map is an explicit tensor in a params dict, so ``get_psf(params)``
is differentiable in a leaf the caller owns, and the gradient reaches it
through the PSF simulation (complex fields through ``torch.fft``), the
``conv_doe`` data term and the solver.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.fft import psf2otf_traced
from ...utils.misc import resolve_device
from ...utils.profiling import span


def get_coordinate(nx: int, ny: int, dx: float, dy: float):
    """Centred grid coordinates, two [nx, ny] float32 arrays."""
    x = (np.arange(nx) - (nx - 1.0) / 2) * dx
    y = (np.arange(ny) - (ny - 1.0) / 2) * dy
    xx, yy = np.meshgrid(x, y, indexing="ij")
    return xx.astype(np.float32), yy.astype(np.float32)


def area_downsampling(x: torch.Tensor, target_side: int) -> torch.Tensor:
    """Block mean of [B, C, H, H] down to [B, C, target_side, target_side]."""
    H = x.shape[2]
    if H % target_side:
        raise NotImplementedError("wave resolution must divide patch size")
    f = H // target_side
    B, C = x.shape[:2]
    return x.reshape(B, C, target_side, f, target_side, f).mean(dim=(3, 5))


def psf2otf_4d(psf: torch.Tensor, out_hw) -> torch.Tensor:
    """[B, C, fh, fw] PSF -> its OTF at ``out_hw`` (``psf2otf_traced``)."""
    return psf2otf_traced(psf, out_hw)


def img_psf_conv(img: torch.Tensor, psf: torch.Tensor, circular: bool = True) -> torch.Tensor:
    """FFT convolution of a [B, C, H, W] image with a simulated PSF;
    ``circular=False`` pads the image to twice its size (ceil before,
    floor after) and crops the result back."""
    if not circular:
        H, W = img.shape[2], img.shape[3]
        top, bottom = int(np.ceil(H / 2)), int(np.floor(H / 2))
        left, right = int(np.ceil(W / 2)), int(np.floor(W / 2))
        img = F.pad(img, (left, right, top, bottom))
    otf = psf2otf_4d(psf, img.shape[-2:])
    result = torch.fft.ifft2(torch.fft.fft2(img) * otf).real
    if not circular:
        result = result[:, :, top:-bottom, left:-right]
    return result


@dataclasses.dataclass
class DOEModelConfig:
    """The reference optic: a 748-pixel patch sampled at 2 um on a 1496^2
    wave grid, the sensor at 15 mm."""

    circular: bool = True
    aperture_diameter: float = 3e-3
    sensor_distance: float = 15e-3
    refractive_idcs: tuple = (1.4648, 1.4599, 1.4568)
    wave_lengths: tuple = (460e-9, 550e-9, 640e-9)
    num_steps: int = 10001
    patch_size: int = 748
    sample_interval: float = 2e-6
    wave_resolution: Tuple[int, int] = (1496, 1496)


class HeightMap(nn.Module):
    """Height map <-> phase. The learnable quantity is ``height_map_sqrt``
    (squared to stay positive), initialised to a Fresnel lens.

    Buffer ``phase_scale`` ([1, C, 1, 1] float32) is wave number x (n - 1),
    computed in float64 and rounded to float32 before it multiplies the
    squared height map, as in the JAX package (the product is ~1e7, so
    another order moves the phases)."""

    def __init__(self, wave_lengths, refractive_idcs, xx, yy, sensor_distance):
        super().__init__()
        self.wave_lengths = np.asarray(wave_lengths, np.float64)
        self.refractive_idcs = np.asarray(refractive_idcs, np.float64)
        self.delta_N = (self.refractive_idcs - 1.0).reshape(1, -1, 1, 1)
        self.wave_nos = (2.0 * np.pi / self.wave_lengths).reshape(1, -1, 1, 1)
        self.xx, self.yy = xx, yy
        self.sensor_distance = sensor_distance
        self.register_buffer("phase_scale", torch.from_numpy(
            np.asarray(self.wave_nos * self.delta_N, np.float32)))

    def fresnel_height_map_sqrt(self, idx: int = 1) -> torch.Tensor:
        """sqrt of the Fresnel lens focused at the sensor for wavelength
        ``idx``, [1, 1, H, W] float32 on the module's device."""
        k = 2 * np.pi / self.wave_lengths[idx]
        fresnel_phase = -k * ((self.xx**2 + self.yy**2)[None, None] / (2 * self.sensor_distance))
        fresnel_phase = np.mod(fresnel_phase, 2 * np.pi)
        hm = self.phase_to_height_map(fresnel_phase, idx)
        return torch.from_numpy(np.asarray(np.sqrt(hm), np.float32)).to(self.phase_scale.device)

    def phase_to_height_map(self, phi, wave_length_idx: int = 1):
        wave_length = self.wave_lengths[wave_length_idx]
        delta_n = self.delta_N.ravel()[wave_length_idx]
        k = 2.0 * np.pi / wave_length
        phi = phi % (2 * np.pi)
        return phi / k / delta_n

    def get_phase_profile(self, height_map_sqrt: torch.Tensor) -> torch.Tensor:
        """exp(i phase) of the height map, [1, C, H, W] complex64."""
        if height_map_sqrt.is_complex():
            raise TypeError("height_map_sqrt must be real (got complex: a phase profile? "
                            "pass it as get_psf(phase_profile=...) instead)")
        phi = self.phase_scale * torch.square(height_map_sqrt)
        return torch.polar(torch.ones_like(phi), phi)


class FresnelPropagator(nn.Module):
    """Transfer-function Fresnel propagation of a field padded by a quarter
    of its size on each side. Buffer ``H`` ([1, C, M, N] complex64) is
    made on the host in float64."""

    def __init__(self, input_shape, distance, discretization_size, wave_lengths):
        super().__init__()
        _, C, M_orig, N_orig = input_shape
        Mpad, Npad = M_orig // 4, N_orig // 4
        self.Mpad, self.Npad = Mpad, Npad
        M, N = M_orig + 2 * Mpad, N_orig + 2 * Npad
        xx, yy = get_coordinate(M, N, 1, 1)
        fx = np.fft.ifftshift(xx / (discretization_size * N))
        fy = np.fft.ifftshift(yy / (discretization_size * M))
        sq = (fx**2 + fy**2)[None, None]
        wl = np.asarray(wave_lengths).reshape(1, -1, 1, 1)
        phi = -np.pi * distance * wl * sq
        self.register_buffer("H", torch.from_numpy(np.exp(1j * phi).astype(np.complex64)))

    def forward(self, field: torch.Tensor) -> torch.Tensor:
        Mpad, Npad = self.Mpad, self.Npad
        padded = F.pad(field, (Npad, Npad, Mpad, Mpad))
        out = torch.fft.ifft2(torch.fft.fft2(padded) * self.H)
        return out[:, :, Mpad:-Mpad, Npad:-Npad]


def simulate_psf(model: nn.Module, phase_profile: torch.Tensor) -> torch.Tensor:
    """The PSF of ``phase_profile`` through ``model``'s aperture and
    propagator: |field|^2 block-summed to the patch, normalised to sum 1.
    Traced as the span ``dprox.optic`` (utils/profiling.py)."""
    with span("dprox.optic"):
        field = model.propagator(model.aperture * (phase_profile * model.input_field))
        psfs = area_downsampling(field.abs() ** 2, model.patch_size)
        return psfs / psfs.sum()


class RGBCollimator(nn.Module):
    """DOE imaging model: phase profile x aperture -> Fresnel propagation
    -> |field|^2 -> area downsampling -> PSF normalised to sum 1.

    Buffers (on the module's device): ``input_field`` ([1, C, R, R] ones),
    ``aperture`` ([1, 1, R, R], a disc), the propagator's ``H`` and the
    height map's ``phase_scale``."""

    def __init__(self, sensor_distance, refractive_idcs, wave_lengths, patch_size,
                 sample_interval, wave_resolution):
        super().__init__()
        self.wave_res = wave_resolution
        self.wave_lengths = wave_lengths
        self.sensor_distance = sensor_distance
        self.sample_interval = sample_interval
        self.patch_size = patch_size
        self.refractive_idcs = refractive_idcs
        xx, yy = get_coordinate(wave_resolution[0], wave_resolution[1],
                                sample_interval, sample_interval)
        self.xx, self.yy = xx, yy
        r = np.sqrt(xx**2 + yy**2)
        self.register_buffer("input_field", torch.ones((1, len(wave_lengths), *wave_resolution)))
        self.register_buffer("aperture", torch.from_numpy(
            (r < xx.max()).astype(np.float32)[None, None]))
        self.height_map = HeightMap(wave_lengths, refractive_idcs, xx, yy, sensor_distance)
        self.propagator = FresnelPropagator((1, len(wave_lengths), *wave_resolution),
                                            sensor_distance, sample_interval, wave_lengths)

    def init_params(self) -> dict:
        """{"height_map_sqrt": the Fresnel lens}, on the module's device."""
        return {"height_map_sqrt": self.height_map.fresnel_height_map_sqrt(1)}

    def get_psf(self, params: Optional[dict] = None,
                phase_profile: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[1, C, patch, patch] float32 PSF of ``params["height_map_sqrt"]``
        (or of a given phase profile), summing to 1."""
        if phase_profile is None:
            phase_profile = self.height_map.get_phase_profile(params["height_map_sqrt"])
        return simulate_psf(self, phase_profile)

    def forward(self, input_img, params: Optional[dict] = None, phase_profile=None,
                circular: bool = False):
        """(the image seen through the optic, the PSF)."""
        psfs = self.get_psf(params, phase_profile)
        return img_psf_conv(input_img, psfs, circular=circular), psfs


def build_doe_model(config: DOEModelConfig = DOEModelConfig(), device="cuda") -> RGBCollimator:
    """``RGBCollimator`` of ``config`` on ``device``."""
    return RGBCollimator(config.sensor_distance, refractive_idcs=config.refractive_idcs,
                         wave_lengths=config.wave_lengths, patch_size=config.patch_size,
                         sample_interval=config.sample_interval,
                         wave_resolution=config.wave_resolution).to(resolve_device(device))


def build_baseline_height_map_sqrt(model: RGBCollimator) -> np.ndarray:
    """sqrt height map of the Fresnel-lens baseline (the lens for the middle
    wavelength), [1, 1, R, R] float32 numpy."""
    k = 2 * np.pi / np.asarray(model.wave_lengths)[1]
    fresnel_phase = -k * ((model.xx**2 + model.yy**2)[None, None] / (2 * model.sensor_distance))
    fresnel_phase = np.mod(fresnel_phase, 2 * np.pi)
    height_map = model.height_map.phase_to_height_map(fresnel_phase, 1)
    return np.sqrt(np.asarray(height_map, np.float32))


def build_baseline_profile(model: RGBCollimator) -> torch.Tensor:
    """Phase profile of the Fresnel-lens baseline, [1, C, R, R] complex64."""
    hms = torch.from_numpy(build_baseline_height_map_sqrt(model))
    return model.height_map.get_phase_profile(hms.to(model.aperture.device))

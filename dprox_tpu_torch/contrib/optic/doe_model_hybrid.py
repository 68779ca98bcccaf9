"""Hybrid refractive-diffractive DOE model.

Counterpart of dprox_tpu/contrib/optic/doe_model_hybrid.py: the DOE phase
rides on a fixed refractive (Fresnel) lens phase, with Sellmeier indices
of fused silica and a half-circular or circular aperture; the learnable
height map is an explicit tensor in a params dict.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...utils.misc import resolve_device
from .doe_model import FresnelPropagator, HeightMap, get_coordinate, img_psf_conv, simulate_psf


def sellmeier_fused_silica(wavelengths_m) -> np.ndarray:
    """Refractive indices of fused silica at the wavelengths (meters)."""
    wvl_um = np.asarray(wavelengths_m) * 1e6
    return np.sqrt(1
                   + 0.6961663 / (1 - (0.0684043 / wvl_um) ** 2)
                   + 0.4079426 / (1 - (0.1162414 / wvl_um) ** 2)
                   + 0.8974794 / (1 - (9.896161 / wvl_um) ** 2))


@dataclasses.dataclass
class HybridDOEModelConfig:
    circular: bool = True
    aperture_diameter: float = 9e-3
    aperture_type: str = "half_circular"  # or "circular"
    sensor_distance: float = 50e-3
    wave_lengths: tuple = (460e-9, 550e-9, 640e-9)
    num_steps: int = 10001
    patch_size: int = 512
    sample_interval: float = 5.4e-6
    wave_resolution: Tuple[int, int] = (1536, 1536)


class HybridRGBCollimator(nn.Module):
    """DOE + refractive lens imaging model. Buffers: ``input_field``,
    ``aperture``, ``refractive_len`` (the lens phase per wavelength,
    [1, C, R, R] float32), the propagator's ``H``."""

    def __init__(self, config: HybridDOEModelConfig):
        super().__init__()
        self.config = config
        wl = config.wave_lengths
        self.wave_res = config.wave_resolution
        self.wave_lengths = wl
        self.refractive_idcs = sellmeier_fused_silica(wl)
        self.patch_size = config.patch_size
        self.sensor_distance = config.sensor_distance
        xx, yy = get_coordinate(self.wave_res[0], self.wave_res[1],
                                config.sample_interval, config.sample_interval)
        self.xx, self.yy = xx, yy
        r = np.sqrt(xx**2 + yy**2)
        if config.aperture_type == "half_circular":
            ap = ((yy > 0) & (r < xx.max())).astype(np.float32)
        else:
            ap = (r < xx.max()).astype(np.float32)
        self.register_buffer("input_field", torch.ones((1, len(wl), *self.wave_res)))
        self.register_buffer("aperture", torch.from_numpy(ap[None, None]))
        self.height_map = HeightMap(wl, self.refractive_idcs, xx, yy, config.sensor_distance)
        self.propagator = FresnelPropagator((1, len(wl), *self.wave_res), config.sensor_distance,
                                            config.sample_interval, wl)
        self.register_buffer("refractive_len", torch.from_numpy(self._refractive_len()))

    def _refractive_len(self) -> np.ndarray:
        phases = []
        for wl in self.wave_lengths:
            k = 2 * np.pi / wl
            ph = -k * ((self.xx**2 + self.yy**2)[None, None] / (2 * self.sensor_distance))
            phases.append(np.mod(ph, 2 * np.pi))
        return np.concatenate(phases, axis=1).astype(np.float32)

    def init_params(self) -> dict:
        return {"height_map_sqrt": self.height_map.fresnel_height_map_sqrt(1)}

    def get_phase_profile(self, params) -> torch.Tensor:
        """exp(i (DOE phase + lens phase)), [1, C, R, R] complex64; the
        height map is (height_map_sqrt + 1e-7)^2."""
        height_map = torch.square(params["height_map_sqrt"] + 1e-7)
        phi = self.height_map.phase_scale * height_map + self.refractive_len
        return torch.polar(torch.ones_like(phi), phi)

    def get_psf(self, params: Optional[dict] = None,
                phase_profile: Optional[torch.Tensor] = None) -> torch.Tensor:
        if phase_profile is None:
            phase_profile = self.get_phase_profile(params)
        return simulate_psf(self, phase_profile)

    def forward(self, input_img, params=None, phase_profile=None, circular: bool = False):
        psfs = self.get_psf(params, phase_profile)
        return img_psf_conv(input_img, psfs, circular=circular), psfs


def build_hybrid_doe_model(config: HybridDOEModelConfig = HybridDOEModelConfig(),
                           device="cuda") -> HybridRGBCollimator:
    """``HybridRGBCollimator`` of ``config`` on ``device``."""
    return HybridRGBCollimator(config).to(resolve_device(device))

"""The reference's ``contrib.optic.common`` names: the wave-optics helpers
(defined in ``doe_model``) and the phase-shift thickness.

Counterpart of dprox_tpu/contrib/optic/common.py.
"""
from __future__ import annotations

import numpy as np

from .doe_model import (FresnelPropagator, area_downsampling, get_coordinate,  # noqa: F401
                        img_psf_conv, psf2otf_4d)


def get_one_phase_shift_thickness(wave_lengths, refractive_index):
    """Thickness (meters) of material that shifts the phase by 2 pi:
    lambda / (n - 1)."""
    wave_lengths = np.asarray(wave_lengths)
    delta_n = refractive_index - 1.0
    wave_nos = 2.0 * np.pi / wave_lengths
    return (2.0 * np.pi) / (wave_nos * delta_n)

from .prior import deep_prior, get_denoiser
from .denoisers import (
    Denoiser,
    Denoiser2D,
    FFDNetDenoiser,
    FFDNetColorDenoiser,
    TVDenoiser,
    Augment,
    BF16Denoiser,
    DeepTVDenoiser,
    EnsembleDenoiser,
)

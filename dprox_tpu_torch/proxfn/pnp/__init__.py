from .prior import deep_prior, get_denoiser
from .grunet import GRUNetDenoiser, GRUNetTVDenoiser, QRNN3DDenoiser
from .denoisers import (
    Denoiser,
    Denoiser2D,
    FFDNetDenoiser,
    FFDNetColorDenoiser,
    FFDNet3DDenoiser,
    DRUNetDenoiser,
    IRCNNDenoiser,
    UNetDenoiser,
    TVDenoiser,
    Augment,
    BF16Denoiser,
    DeepTVDenoiser,
    EnsembleDenoiser,
)

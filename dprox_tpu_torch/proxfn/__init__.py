from .base import ProxFn
from .sum_squares import ext_sum_squares, least_squares, sum_squares, weighted_sum_squares
from .simple import nonneg, norm1, norm2
from .pnp import deep_prior, get_denoiser
from .fast import compress_sensing, csmri, misr, phase_ret, sisr, spi
from .nlm import patch_nlm
from .unrolled import unrolled_prior

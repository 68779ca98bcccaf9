from .base import ProxFn
from .sum_squares import sum_squares, weighted_sum_squares, least_squares
from .simple import nonneg, norm1, norm2
from .pnp import deep_prior, get_denoiser

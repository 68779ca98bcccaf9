"""Operations and bytes of the port's work, counted from shapes.

The yardstick of every roofline and peak share the benchmark reports. It
is frozen here, apart from the program, so that a change to a kernel
cannot change how that kernel is judged. The peaks are NVIDIA's data
sheet for one H100 SXM (dense, no sparsity, 700 W), as the port's chip
smoke test states them; the byte counts read each input byte once and
write each output byte once, as PERF.md's kernel table counts them.
"""
from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
PEAK_TF32_OPS_PER_S = 494.7e12  # TF32 on the tensor cores, dense (989.4 with sparsity)
F32 = 4  # bytes
C64 = 8

# operations per element of the elementwise parts, counted from the
# expressions the solvers evaluate (a complex add counts 2, a complex by
# real divide 2)
TV_OPS_PER_CELL_ITERATION = 16  # two half-steps of x0 (6), two dual updates (10)
DIVIDE_OPS_PER_ELEMENT = 6      # (F + eps) / (diag + rho + eps)
ADMM_OPS_PER_ELEMENT = 5        # v - u, rho * (v - u), Kx + u, u + Kx - v
FUSION_OPS_PER_ELEMENT = 3      # w * d + (1 - w) * t
FFT_FLOPS_PER_POINT_LOG = 5     # 5 N log2 N for a complex FFT of N points
# preconditioned CG on K^T K + rho with K = mask * conv and M^-1 = F^-1 (F r
# / (surrogate + rho)): a matvec is 4 FFTs and 16 operations an element
# (two masks, two complex products, rho v and the sum), M^-1 2 FFTs and 3
CG_ITERATION_FFTS = 6           # A p, M^-1 r
# A p 16, M^-1 3, two dot products 4, the x, r and p updates 6, the stop
# test's max |r| 1
CG_ITERATION_OPS_PER_ELEMENT = 30
CG_SETUP_FFTS = 6               # A x, M^-1 r
# K^T b + rho z 2, A x 16, r 1, M^-1 3, r.z 2, max |rhs| and max |r| 2
CG_SETUP_OPS_PER_ELEMENT = 26


def conv_peak(tf32: bool) -> float:
    """The peak a configuration's convolutions run against: the tensor
    cores' TF32 where cuDNN may use it, float32 otherwise."""
    return PEAK_TF32_OPS_PER_S if tf32 else PEAK_F32_OPS_PER_S


def bound_s(nbytes: float, ops: float) -> float:
    """Least time the card could take: the larger of bytes over peak
    bandwidth and operations over the float32 peak, in seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def conv3x3_flops(c_in: int, c_out: int, h: int, w: int) -> float:
    """A 'same' 3x3 convolution: a multiply and an add per tap."""
    return 2.0 * 9 * c_in * c_out * h * w


def ffdnet_flops(in_nc: int, nc: int, nb: int, h: int, w: int) -> float:
    """FFDNet's convolutions on one [in_nc, h, w] image: pixel-unshuffled
    by 2, the noise map as one more input channel, nb 3x3 layers
    (in_nc * 4 + 1 -> nc, nb - 2 of nc -> nc, nc -> in_nc * 4) at half
    resolution (h and w rounded up to even)."""
    hh, ww = (h + 1) // 2, (w + 1) // 2
    layers = ([(in_nc * 4 + 1, nc)] + [(nc, nc)] * (nb - 2) + [(nc, in_nc * 4)])
    return sum(conv3x3_flops(ci, co, hh, ww) for ci, co in layers)


def fft2_flops(planes: int, h: int, w: int) -> float:
    """One complex 2-D FFT over ``planes`` planes of h x w points."""
    n = h * w
    return FFT_FLOPS_PER_POINT_LOG * planes * n * math.log2(n)


def tv_bytes(planes: int, h: int, w: int) -> float:
    """``tv_denoise_chw``: y0 read once, the output written once."""
    return 2.0 * planes * h * w * F32


def tv_ops(planes: int, h: int, w: int, iterations: int) -> float:
    return float(TV_OPS_PER_CELL_ITERATION * planes * h * w * iterations)


def freq_divide_bytes(planes: int, h: int, w: int, divisor_elements: int) -> float:
    """``freq_divide``: the complex64 spectrum read and written, the real
    divisor read once."""
    return 2.0 * C64 * planes * h * w + F32 * divisor_elements


def freq_divide_ops(planes: int, h: int, w: int) -> float:
    return float(DIVIDE_OPS_PER_ELEMENT * planes * h * w)


def bdot_bytes(rows: int, n: int) -> float:
    """``bdot``: both operands read once, one float32 a row written."""
    return 2.0 * F32 * rows * n + F32 * rows


def bdot_ops(rows: int, n: int) -> float:
    return 2.0 * rows * n

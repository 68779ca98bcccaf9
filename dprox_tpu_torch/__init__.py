"""dprox_tpu_torch — the PyTorch/CUDA port of dprox_tpu.

Mirrors the module paths and public names of the JAX package
(``import dprox_tpu_torch as dp``; ``dp.Variable``, ``dp.conv``,
``dp.sum_squares``, ``dp.nonneg``, ``dp.deep_prior``, ``dp.compile``,
``dp.LinearSolveConfig``, ``dp.log_descent``)
with PyTorch idiom: tensors, ``nn.Module`` denoisers, an eager solver
loop and an explicit ``device`` (default ``"cuda"``; asking for CUDA
without a GPU raises). The hot kernels are hand-written for Hopper
(``ops/kernels.py``, sources in ``csrc/``). Ported so far, all under
``admm``: PnP deconvolution with the flagship ``distilled_color_tv``
prior; deconvolution with ``nonneg`` / ``norm1`` / ``norm2`` (the
``fused_admm_update`` kernel); spatially diagonal x-updates (demosaic);
and the CG x-update for objectives no transform diagonalizes (joint
demosaic + deconvolution: ``mosaic(conv(x))``), with the differentiable
``linear_solve``, the solvers of ``linalg`` and the ``bdot`` and
``fused_cg_tail`` kernels. Beside the imaging solvers, the LP path
(``dp.algo.lp``: ``solve_lp``, ``LPProblem``, ``LPSolverADMM``, the
scenario-consensus solver, and ``BSRMat`` on the ``bsr_matvec`` kernel)
with the energy-planning instances of ``dp.contrib.energy_system``.
"""

__version__ = "0.1.0"

from . import algo, contrib, linalg, linop, ops, proxfn, utils
from .algo import ADMM, Algorithm, compile, log_descent
from .linalg import LinearSolveConfig, linear_solve
from .linop import (Constant, LinOp, Placeholder, Variable, adjoint, conv, est_norm,
                    eval, grad, gram, mosaic, mul_elementwise, scale, sum, validate,
                    vstack)
from .proxfn import (ProxFn, deep_prior, get_denoiser, least_squares, nonneg, norm1,
                     norm2, sum_squares)
from .utils.misc import to_tensor as tensor

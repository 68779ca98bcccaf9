"""dprox_tpu_torch — the PyTorch/CUDA port of dprox_tpu.

Mirrors the module paths and public names of the JAX package
(``import dprox_tpu_torch as dp``; ``dp.Variable``, ``dp.conv``,
``dp.sum_squares``, ``dp.deep_prior``, ``dp.Problem``, ``dp.compile``,
``dp.LinearSolveConfig``, ``dp.log_descent``) with PyTorch idiom:
tensors, ``nn.Module`` denoisers, an eager solver loop and an explicit
``device`` (default ``"cuda"``; asking for CUDA without a GPU raises). The
hot kernels are hand-written for Hopper (``ops/kernels.py``, sources in
``csrc/``). Ported so far:

* the imaging front end: ``Problem`` (with the absorb pass and the LP
  dispatch of ``c @ x`` objectives) and ``compile`` with every solver of
  the JAX package: ``admm`` (its ``nonneg`` / ``norm1`` blocks through the
  ``fused_admm_update`` kernel), ``ladmm``, ``admm_vxu``, ``hqs``, ``pc``,
  ``pgd`` and the consensus ``cadmm``; per-psi-fn and per-sample
  schedules;
* the x-updates: frequency-diagonal (the ``freq_divide`` kernel),
  spatially diagonal (demosaic), and CG for objectives no transform
  diagonalizes (``mosaic(conv(x))``), with the differentiable
  ``linear_solve``, the solvers of ``linalg`` and the ``bdot`` and
  ``fused_cg_tail`` kernels; ``weighted_sum_squares`` and
  ``sum_squares.grad``;
* the plug-and-play priors: TV (2-D through the ``tv_denoise_chw`` kernel,
  3-D plain) and the FFDNet family with shipped weights, gray and color,
  fused with TV, in bfloat16, as ensembles and as the x8 self-ensemble
  (``deep_prior(x8=True)``); the rest of the denoiser zoo (DRUNet and the
  FFDNet + DRUNet ``ensemble_tv``, IRCNN, UNet, FFDNet3D, the GRUNet and
  QRNN3D hyperspectral nets, non-local means ``patch_nlm``) and the
  DGUNet ``unrolled_prior`` with its stateful loop, with the derain
  pipeline (``contrib.derain``);
* the specializations (``dp.specialize``, ``dp.train``): unrolling with
  learned schedules, the deep-equilibrium solver with its implicit
  backward (Anderson and Broyden), the RL tuner (direct backprop and
  DDPG) and the supervised training loop, with the shipped trained
  solvers' weights;
* the LP path (``dp.algo.lp``: ``solve_lp``, ``LPProblem``,
  ``LPSolverADMM``, the scenario-consensus solver, and ``BSRMat`` on the
  ``csr_matvec`` / ``bsr_matvec`` kernels) with the energy-planning
  instances of ``dp.contrib.energy_system``.
"""

__version__ = "0.1.0"

from . import algo, contrib, linalg, linop, ops, proxfn, utils
from .algo import (ADMM, ADMM_vxu, HQS, Algorithm, AutoTuneSolver, DEQSolver, LinearizedADMM,
                   PockChambolle, Problem, ProximalGradientDescent, UnrolledSolver, compile,
                   log_descent, optimize, specialize, train, visualize)
from .linalg import LinearSolveConfig, linear_solve
from .linop import (BlackBox, Constant, LinOp, LinOpFactory, Placeholder, Variable, adjoint, conv,
                    conv_doe, copy, est_CompGraph_norm, est_norm, eval, grad, gram, mosaic,
                    mul_color, mul_elementwise, scale, split, sum, validate, vstack)
from .proxfn import (ProxFn, compress_sensing, csmri, deep_prior, ext_sum_squares, get_denoiser,
                     least_squares, misr, nonneg, norm1, norm2, patch_nlm, phase_ret, sisr, spi,
                     sum_squares, unrolled_prior, weighted_sum_squares)
from .utils.misc import to_tensor as tensor

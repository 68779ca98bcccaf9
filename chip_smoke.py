#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dprox_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure (any failure
exits non-zero):

1. build    - compile the Hopper kernels from csrc/ with nvcc.
2. check    - hold each kernel against its plain PyTorch version on the
              card, at the main path's shapes and at odd sizes (the TV
              kernel bit for bit, in each of its windows), and time
              kernel, plain version and library call with CUDA events
              (three lines: check, check_solver_kernels, check_bsr; the
              last holds both routes of the LP operator, dense tiles and
              compressed rows, on every operator and times both).
3. main     - the flagship PnP-ADMM deconvolution at 512x512x3 with the
              distilled_color_tv prior (FFDNet nc=96 nb=10 + TV), through
              dp.compile(...).solve(...), with the kernels' launch counts
              read around that one solve; its PSNR is held against the
              JAX package's value for the same solve on the CPU.
4. marginal - marginal iterations/s from the differenced 8 -> 48 span,
              and a per-stage breakdown of one iteration.
5. nonneg   - deconvolution with nonneg(x) at 512x512x3 (frequency
              x-update + the fused ADMM update): iterations until the
              primal and dual residuals fall below 1e-4 and the PSNR,
              both held against the JAX package on the CPU; launch
              counts; the fused route against the generic prox + dual
              update, bit for bit; marginal iterations/s (24 -> 224).
6. joint    - joint demosaic + deconvolution at 256x256x3, 24 outer
              iterations, through the CG x-update: with the fused-tail
              solver (cg_pallas) and with the default config
              (preconditioned CG); PSNR held against the JAX package on
              the CPU, launch counts (the inner CG iterations follow from
              them), marginal outer iterations/s (4 -> 24), and
              what the per-iteration stop test's host read costs.
   grad     - gradients through the kernels' autograd Functions at
              1x3x256x256: d loss / d (rhos, lams) of 5-iteration admm
              solves with norm1(grad(x)) and with the TV prior, and d loss
              / d (rho, b) of cg_pallas, each against the same computation
              on the CPU (plain versions).
7. lp       - the energy-planning LP synthetic_cep_model(512, 16) (16912 x
              8208 constraint matrix, 324 dense 128 x 128 tiles) in float32
              through LPProblem / LPSolverADMM.solve_fused: convergence,
              objective against HiGHS (scipy.optimize.linprog, solved
              here), feasibility against the JAX package on the CPU,
              csr_matvec (the operator's route) and bdot launch counts
              against the iteration counts, one ADMM iteration's stages;
              then hyperparameter pretraining through the kernel's
              backward (pretrain_lp, solve_lp), the chunked solve at
              synthetic_cep_model(2048, 16) and a float64 solve at
              synthetic_cep_model(64, 8).
8. lp_consensus - synthetic_cep_scenarios(64, 8, 8) through
              solve_consensus_lp(fused=True) in float32 against the HiGHS
              optimum of the extensive form, twice, bit for bit.
9. family   - the FFDNet prior family on the 512x512x3 deconvolution:
              the flagship with x8=True (8 TV launches an iteration),
              distilled_color_tv_bf16, res_ffdnet_color_tv, and
              distilled_gray_tv on the face's 1x1x512x512 luminance; each
              PSNR held against the JAX package on the CPU, launch counts,
              marginal iterations/s, one iteration's eager and device time;
              and one x8 denoise of a 3x384x512 input (TV planes 384x512
              and 512x384) bit for bit against the same call with the
              plain TV.
10. algos   - every solver (admm, ladmm, admm_vxu, hqs, pc, pgd, cadmm)
              on the 512x512x3 nonneg deconvolution, hqs and admm_vxu
              with the flagship prior, dp.Problem on the nonneg problem,
              each PSNR against the JAX package on the CPU, with launch
              counts and one iteration's eager and device time; and the LP
              dispatch dp.Problem(c @ x, [A @ x == b]) against HiGHS.
11. fast    - the fused fast proxes and complex solver states: CS-MRI
              (dp.csmri + deep_prior, admm, 24 iterations, real_output) on
              the 128x128 phantoms of the tests/paper/test_csmri_grid.py
              cells with distilled_gray_tv and tv, and CustomADMM, the TV
              kernel once an iteration on the complex state's real part;
              SISR at full width (dp.Problem(dp.sisr(...) +
              deep_prior(x, "res_ffdnet_color_tv")), 1x3x512x512, 24
              iterations) with marginal iterations/s and its stages; the
              HSI sisr, misr and compress_sensing with 3-D TV (no kernel);
              each PSNR against the JAX package on the CPU; and the
              flagship with conv_doe in place of conv against conv's PSNR.
12. special - the specializations through dp.specialize on the shipped
              trained solvers: the color DEQ deconvolution (weights/
              deq_deconv: FFDNet nc=96 nb=10 through the equilibrium,
              1x3x128x128, f_thres 24, b_thres 16) at three held-out (psf,
              noise) settings and annealed (12 levels x 2), the CS-MRI DEQ
              (deq_csmri) on the DEQ_GRID cells, the CS-MRI and deconv
              tuners (autotune_*); each PSNR and Anderson's stopping step
              against the JAX package on the CPU (the tuned CS-MRI solve
              more than 1 dB over log_descent), launch counts against the
              evaluations of f; gradients of training steps through the
              kernels' autograd Functions (the color and the nonneg DEQ's
              implicit backward, 4 train_supervised steps of an unrolled
              solver, the tuner's episode) against the CPU; the DEQ's
              marginal iterations/s against plain ADMM on the same problem,
              one f evaluation and one Anderson step, a training step and
              a tuner episode.

13. zoo     - the rest of the denoiser zoo: tiny_drunet_color_tv (DRUNet
              nc 32..256 nb 2, four 272x272 quadrants a call at 512x512)
              on the flagship deconvolution and ensemble_tv (FFDNet +
              DRUNet + TV) with x8, each PSNR against the JAX package on the
              CPU, launch counts, marginal iterations/s, one iteration's
              eager and device time, one DRUNet call beside one FFDNet call;
              the HSI grid of tests/paper/test_hsi_grid.py (tiny_grunet,
              tiny_grunet_tv) and mid_grunet against tiny_grunet; the trained
              derain pipeline (DGUNet unrolled_prior + LearnableDegOp, 7 PGD
              iterations) on the DERAIN_GOLDEN crops, and a joint training
              step's gradients against the CPU; one call each of IRCNN (a
              CUDA graph captures it: no host read), UNet, QRNN3D, FFDNet3D,
              OpticsUNet and patch_nlm against the CPU, with their times and
              device kernels per call.

Between 2 and 3, phase kernels_per_call counts each wrapper's device
kernels per call in a torch.profiler trace of ten calls; phase
check_complex holds freq_divide's complex-divisor entry against its plain
version and the TV kernel on a complex tensor's real part.

Then one line {"kernels": [...]}, the nvidia-smi name/power-limit line,
and last {"ok": true, "device": {...}}. float32 convolutions and matmuls
run with TF32 off.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM3 bytes/s, and
# float32 and float64 (non-tensor-core) operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12

# PSNR (dB) of the flagship solve below -- _synthetic_face(512, 512), psf
# point_spread_function(15, 5), x0 = b, log_descent(80, 30, 48), 48
# iterations -- computed with the JAX package on the CPU by
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import jax; jax.config.update('jax_platforms','cpu'); import jax.numpy as jnp, dprox_tpu as dp; from dprox_tpu.utils import imaging, metrics; img = jnp.asarray(imaging._synthetic_face(512, 512).transpose(2, 0, 1)[None]); psf = imaging.point_spread_function(15, 5); b = imaging.blurring(img, psf); x = dp.Variable(); s = dp.compile([dp.sum_squares(dp.conv(x, psf) - b), dp.deep_prior(x, 'distilled_color_tv')], 'admm'); r, g = dp.log_descent(80, 30, 48); print(metrics.psnr(b, img), metrics.psnr(s.solve(x0=b, max_iter=48, rhos=r, lams=g), img))"
JAX_CPU_PSNR_B = 24.824332141507487
JAX_CPU_PSNR_X = 28.52431271357178
PSNR_TOL_DB = 0.05

# The nonneg and joint phases feed the port the observation b that the JAX
# package was given: made with numpy in float64 and rounded to float32,
#   def observation(size, psf, mosaic):
#       img = imaging._synthetic_face(512, 512)[:size, :size].transpose(2, 0, 1)[None]
#       otf = psf2otf(np.asarray(psf).squeeze(), (size, size))
#       b = np.real(np.fft.ifft2(otf * np.fft.fft2(img.astype(np.float64)))).astype(np.float32)
#       return img, (b * imaging.bayer_mask((size, size)) if mosaic else b)
# (imaging = dprox_tpu.utils.imaging, psf2otf = dprox_tpu.utils.fft.psf2otf).
# The values below were computed with the JAX package on the CPU
# (JAX_PLATFORMS=cpu, jax.config.update('jax_platforms', 'cpu')) by:
#   psf = imaging.point_spread_function(15, 5); img, b = observation(512, psf, False); x = dp.Variable()
#   s = dp.compile([dp.sum_squares(dp.conv(x, psf) - jnp.asarray(b)), dp.nonneg(x)], 'admm')
#   out, res = s.solve_with_residuals(x0=jnp.asarray(b), max_iter=512, rhos=0.05, lams=0.01)
#   ok = np.where((np.asarray(res['r_primal']) < 1e-4) & (np.asarray(res['r_dual']) < 1e-4))[0]; n = int(ok[0]) + 1
#   metrics.psnr(s.solve(x0=jnp.asarray(b), max_iter=n, rhos=0.05, lams=0.01), img)
JAX_CPU_NONNEG_ITERS = 124
JAX_CPU_NONNEG_PSNR_X = 26.406545602764183
# and, for cfg in (dp.LinearSolveConfig(max_iters=40, solver_type='cg_pallas'), dp.LinearSolveConfig(max_iters=40)):
#   psf = imaging.point_spread_function(9, 2); img, b = observation(256, psf, True); x = dp.Variable()
#   data = dp.sum_squares(dp.mosaic(dp.conv(x, psf)) - dp.Placeholder('b'))
#   s = dp.compile(data + dp.deep_prior(x, 'tv'), 'admm', linear_solve_config=cfg)
#   init = dp.utils.demosaic_from_mosaiced(jnp.asarray(b)); rhos, sig = dp.log_descent(35, 10, 24)
#   metrics.psnr(s.solve(x0=init, max_iter=24, rhos=rhos, lams=sig, params={'b': jnp.asarray(b)}), img)
JAX_CPU_JOINT_PSNR_INIT = 25.143699769015036
JAX_CPU_JOINT_PSNR_X = {"cg_pallas": 26.921728215415563, "default_pcg": 26.936196782092523}

# The family and algos phases: PSNRs (dB) of the JAX package on the CPU on
# the observations these phases make (observation(512, psf(15, 5), False)
# and its luminance, luminance_observation), printed by
#   JAX_PLATFORMS=cpu python scripts/smoke_references.py
# (each solve's settings are in that script and in the phases below).
JAX_CPU_FAMILY_PSNR_X = {"distilled_color_tv_x8": 28.631571643994956,
                         "distilled_color_tv_bf16": 28.526233903982913,
                         "res_ffdnet_color_tv": 28.314767701237177,
                         "distilled_gray_tv": 31.383059853972934}
JAX_CPU_ALGOS_PSNR_X = {"admm_nonneg": 25.890694149953802, "ladmm_nonneg": 25.890694149953802,
                        "admm_vxu_nonneg": 25.893772648818064,
                        "hqs_nonneg": 25.890018955947134, "pc_nonneg": 25.273496359907913,
                        "pgd_nonneg": 25.178723613267586, "cadmm_nonneg": 25.69494932870684,
                        "hqs_distilled_color_tv": 28.507916177775027,
                        "admm_vxu_distilled_color_tv": 28.52154720381231,
                        "problem_nonneg": 25.890694149953802}
# The bf16 limit sits between two readings on this observation: the bf16
# flagship on an H100 (80GB HBM3, 700 W) was 4.7e-4 dB below its JAX-CPU
# value (cuDNN's and XLA-CPU's bf16 convolutions round their sums
# differently, and the solve feeds the denoiser's outputs back for 48
# iterations); the float32 flagship at the same settings on the CPU
# (JAX_CPU_FLOAT32_AT_BF16_SETTINGS, from the same script) is 1.96e-3 dB
# below it, so a bf16 kind that silently stayed in float32 fails the gate.
PSNR_TOL_BF16_DB = 0.001
JAX_CPU_FLOAT32_AT_BF16_SETTINGS = 28.524274948115913
LUMA = np.array([0.299, 0.587, 0.114])  # ITU-R BT.601 luminance weights

# The fast phase: PSNRs (dB) of the JAX package on the CPU, printed under
# "fast" by
#   JAX_PLATFORMS=cpu python scripts/smoke_references.py
# on the inputs this phase makes: contrib.csmri.generate_sample(128, lines,
# sigma) at the cells of tests/paper/test_csmri_grid.py with its noise-
# adaptive schedule (24 iterations, real_output=True) and CustomADMM at
# (40, 0.0) (8 iterations, rho 0.2, lam 0.05, TV); SISR on the synthetic
# face (sr_observation, psf(15, 2), sf 2) through dp.Problem with
# res_ffdnet_color_tv, log_descent(60, 20, 24); and the mPSNRs of the HSI
# solves with 3-D TV on synthetic_hsi (24 iterations), whose goldens in
# tests/paper/test_hsi_grid.py are HSI_GOLDEN_MPSNR (0.2 dB there).
CSMRI_CELLS = [(50, 0.0), (40, 0.0), (40, 0.05), (30, 0.05)]
JAX_CPU_FAST_PSNR_X = {
    "csmri_distilled_gray_tv_50_0.0": 30.75021287439608,
    "csmri_tv_50_0.0": 25.332006194195003,
    "csmri_distilled_gray_tv_40_0.0": 30.320940796738455,
    "csmri_tv_40_0.0": 25.714147513135504,
    "csmri_distilled_gray_tv_40_0.05": 22.762707558977745,
    "csmri_tv_40_0.05": 20.976253026727726,
    "csmri_distilled_gray_tv_30_0.05": 21.209944720468947,
    "csmri_tv_30_0.05": 19.431169459229245,
    "csmri_custom_admm_40_0.0": 20.42147499236266,
    "sisr_res_ffdnet_color_tv": 26.913758997271316,
    "hsi_sisr": 26.695096534892773,
    "hsi_misr": 31.919074233678984,
    "hsi_cs": 30.20639654241175}
HSI_GOLDEN_MPSNR = {"sisr": 26.70, "misr": 31.92, "cs": 30.21}
# conv_doe against conv on the flagship in the same call: the same OTF,
# made on the card in float32 from the PSF (psf2otf_traced) instead of on
# the host in float64 (psf2otf); they differ by float32 rounding (~1e-7),
# which moved the PSNR by ~1e-7 dB on the CPU with the TV prior (128^2 and
# 256^2 crops, 48 iterations)
CONV_DOE_GAP_DB = 1e-3

# The special phase: the shipped trained solvers (weights/deq_deconv, deq_csmri,
# autotune_csmri, autotune_deconv) with the JAX package on the CPU, printed
# under "special" by
#   JAX_PLATFORMS=cpu python scripts/smoke_references.py special
# on the inputs this phase makes (deq_observation: the face's 128x128 crop
# blurred in float64 with numpy plus numpy noise; the CS-MRI phantoms):
# PSNRs, Anderson's evaluations of f (its stopping step) forward and, for a
# training step, backward, and the residuals its stop test read (eps 1e-3).
DEQ_DECONV_CELLS = [(5.0, 0.01), (5.0, 0.02), (7.0, 0.03)]  # (psf sigma, noise) held out
DEQ_CSMRI_CELLS = [(50, 0.0), (40, 0.05)]  # tests/paper/test_csmri_grid.py::DEQ_GRID
ANDERSON_EPS = 1e-3
JAX_CPU_SPECIAL = {
    "deq_deconv_0": {"psnr": 25.992279270503428, "forward_evaluations": 8, "forward_res":
        [0.0023593403736491885, 0.0013030385764914258, 0.00077635830211787]},
    "deq_deconv_1": {"psnr": 25.8769302211339, "forward_evaluations": 9, "forward_res":
        [0.0030929129002665195, 0.0017782449589080066, 0.0011314823825377975,
        0.0007782870183491228]},
    "deq_deconv_2": {"psnr": 25.687294943404954, "forward_evaluations": 9, "forward_res":
        [0.0027084059995965233, 0.0015926108392323164, 0.001069120846834345,
        0.0007811781841747034]},
    "deq_deconv_train_step": {"forward_evaluations": 8, "forward_res": [0.002359339667080958,
        0.001303039633686554, 0.0007763636341873484], "backward_evaluations": 16, "backward_res":
        [0.2013844803368019, 0.18543068083567424, 0.2674929277989218, 0.1645294863093614,
        0.11320029459382665, 0.07978715372460163, 0.05619066155114636, 0.04007688973302585,
        0.03179472156760104, 0.029173148418153893, 0.027110967768979914]},
    "deq_deconv_anneal": {"psnr": 32.0968185704496},
    "deq_csmri_50_0.0": {"psnr": 30.993278886109373, "forward_evaluations": 24, "forward_res":
        [0.07418737623012653, 0.059852981124883485, 0.047761933362771694, 0.038751180211904344,
        0.03279677828837007, 0.02672714483195515, 0.021132522742988276, 0.017146331180089146,
        0.013319302325130006, 0.010499653777652728, 0.008755773268588573, 0.0071906317246924435,
        0.005911339282231412, 0.004869900376797957, 0.004084964308793907, 0.003381926303249313,
        0.0028016110414504918, 0.0023168746877436095, 0.001964448069369653]},
    "deq_csmri_40_0.05": {"psnr": 27.514479037069023, "forward_evaluations": 24, "forward_res":
        [0.07564516575463935, 0.05804753459482588, 0.044162289621124805, 0.034893996461353556,
        0.02894217725747762, 0.024668272978450884, 0.021170219640111964, 0.018409347322845843,
        0.015816696924894194, 0.0133516508335627, 0.011097642182087334, 0.00880127203941622,
        0.006974753541808793, 0.005502821884640896, 0.004335624381646497, 0.0034572141356438058,
        0.0027789351415790984, 0.0022522834486825663, 0.001828486371076499]},
    "deq_nonneg_train_step": {"forward_evaluations": 15, "forward_res": [0.0027392968470935832,
        0.002342814963716231, 0.002071271090001445, 0.001877310440580079, 0.0017628928244600042,
        0.0016550720644565818, 0.0015987693346389573, 0.0015227093922561485, 0.0014477803341297751,
        0.0014037469166079289], "backward_evaluations": 15, "backward_res": [0.3705317281504203,
        0.34960039794535785, 0.30456803857346837, 0.2792070963130679, 0.25940211243535516,
        0.24248059505948452, 0.22724144939219842, 0.21304364032292308, 0.19951323412589927,
        0.18821255982198873]},
    "autotune_csmri": {"tuned": 23.28993023449933, "log_descent": 20.23619618575134},
    "autotune_deconv": {"tuned": 26.17169004681086, "log_descent": 26.888173274140236},
}

# The LP phase: synthetic_cep_model(512, 16) in float32. The values below were
# computed with the JAX package on the CPU by
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import jax; jax.config.update('jax_platforms','cpu'); import numpy as np, jax.numpy as jnp; from dprox_tpu.algo.lp import LPProblem, LPSolverADMM; from dprox_tpu.contrib.energy_system import synthetic_cep_model; c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(512, 16); p = LPProblem(c, A_ub, b_ub, A_eq, b_eq, dtype=jnp.float32); x, res = LPSolverADMM(dtype=jnp.float32, verbose=False).solve_fused(p, max_iters=20000); x = np.asarray(x, np.float64); print(res['iters'], c @ x, x.min(), np.abs(A_eq @ x - b_eq).max(), (A_ub @ x - b_ub).max())"
# The float32 residuals of this solve wander around their thresholds from
# iteration ~500 on, so the iteration at which both are first met moves with
# the order of every sum (the port with its plain versions on the CPU stops
# at 4025, objective 51389.382, equality gap 0.0277, inequality gap 0.00325);
# counts are printed, and the gates are objective and feasibility. The same
# holds for the feasibility gaps at the stop: the stopping rule bounds each of
# them by r_norm < eps_primal (0.118 here, in the problem's own units), and
# where below that they land is as much a draw as the count is: the
# inequality gap is 0.0019 in JAX-CPU, 0.0032 in the port on the CPU and
# 0.0159 on an H100. So the gate is what the solver promises, each gap <=
# the solve's r_norm (with 0.1% for float32 against float64 evaluation) and
# r_norm < eps_primal; the line also says whether the gaps are within twice
# the JAX-CPU values, ungated.
JAX_CPU_LP_ITERS = 1700
JAX_CPU_LP_OBJECTIVE = 51399.91388895211
JAX_CPU_LP_X_MIN = -0.0054648746736347675
JAX_CPU_LP_EQ_GAP = 0.03363540104732721   # max |A_eq x - b_eq|
JAX_CPU_LP_UB_GAP = 0.0018959328092797703  # max (A_ub x - b_ub)
LP_OBJECTIVE_TOL = 1e-3         # |c @ x - HiGHS| / |HiGHS|
LP_GAP_SLACK = 1e-3             # each gap <= r_norm * (1 + slack) + 1e-6
LP_X_MIN = -1e-2
CONSENSUS_OBJECTIVE_TOL = 5e-3  # against the extensive form's HiGHS optimum
# max |kernel - plain| / max |plain|, the plain version run on float64
# copies of the same inputs (a float32 sum of thousands of terms in one
# order drifts ~1e-6 from the exact sum, in another order as much again)
SPMV_REL_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
SPMV_SCIPY_REL_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}  # against scipy's float64 A @ x

TV_TOL = 1e-5          # max |kernel - plain|, same op order in float32 (and bit-equal)
# (shape, iterations, lam per plane): the paths' shapes (x8 hands a
# 3x384x512 input over as 384x512 and 512x384 planes), odd sizes, and
# sizes on both sides of the TV kernel's windows (128 columns; 32 and
# 96 rows), 1..44 iterations
TV_CASES = [((3, 512, 512), 10, False), ((3, 256, 256), 5, False), ((3, 384, 512), 10, False),
            ((3, 512, 384), 10, False), ((1, 512, 512), 10, False), ((1, 37, 53), 10, False),
            ((2, 130, 257), 10, True), ((3, 512, 512), 5, False), ((1, 31, 127), 1, False),
            ((2, 32, 128), 5, True), ((1, 33, 129), 10, False), ((2, 63, 257), 10, True),
            ((1, 64, 128), 31, False), ((2, 65, 129), 44, True), ((1, 95, 127), 5, False),
            ((2, 96, 257), 10, True), ((1, 97, 128), 44, False)]
DIVIDE_REL_TOL = 1e-6  # max |kernel - plain| / max |plain|
REDUCE_REL_TOL = 1e-5  # bdot and the CG tail: float32 sums in another order
REDUCE_REL_TOL_F64 = 1e-12  # bdot in float64
# gradients of an unrolled solve on the card against the CPU: cuFFT rounds
# differently from the CPU's FFT, and a pixel within that rounding of a
# threshold (|w| = lam in the soft threshold, |z| = lam / 2 in TV's clip)
# takes the other branch, which moves the gradient w.r.t. lams by one
# pixel's share (4.6e-4 and 6.5e-4 of its largest entry on an H100)
GRAD_REL_TOL = 3e-3
BDOT_LP_ROWS = [(1, 8208), (1, 32784), (1, 520), (8, 520)]  # the LP paths' bdot rows
MAIN_ITERS = 48
NONNEG_CAP = 512
JOINT_ITERS = 24

# The zoo phase: values of the JAX package on the CPU, printed under "zoo" by
#   JAX_PLATFORMS=cpu python scripts/smoke_references.py zoo
# on the inputs this phase makes: the flagship observation (observation(512,
# psf(15, 5))) with deep_prior(x, "tiny_drunet_color_tv") (48 iterations,
# log_descent(80, 30, 48)) and ensemble_tv with x8 (24 iterations,
# log_descent(80, 25, 24)); the HSI grid of tests/paper/test_hsi_grid.py on
# synthetic_hsi (hsi_problem; mPSNR, its goldens HSI_GRID_GOLDEN are held to
# 0.2 dB there); tiny_grunet and mid_grunet denoising the cube plus 0.03 noise
# (mPSNR); the trained derain pipeline (weights/derain_joint.msgpack, 7
# unrolled PGD iterations) on the DERAIN_GOLDEN crops, whose ground truth and
# JAX-made rainy inputs the script writes to tests/data/derain_golden_crops.npz.
JAX_CPU_ZOO = {"tiny_drunet_color_tv": 28.136038566336104, "ensemble_tv_x8": 28.379683282471685,
               "hsi_deblur": 29.50638059713327, "hsi_sisr": 29.32161004891281,
               "hsi_misr": 34.57077746098304, "hsi_cs": 30.352899377916117,
               "denoise_tiny_grunet": 32.15857941964991, "denoise_mid_grunet": 32.49361470557747,
               "derain_0": 31.006056314160276, "derain_4": 33.957510850004724}
HSI_GRID = [("deblur", "tiny_grunet"), ("sisr", "tiny_grunet"), ("misr", "tiny_grunet_tv"),
            ("cs", "tiny_grunet")]  # tests/paper/test_hsi_grid.py::HSI_GRID
HSI_GRID_GOLDEN = {"deblur": 29.51, "sisr": 29.32, "misr": 34.57, "cs": 30.35}
DERAIN_GOLDEN = {0: 31.01, 4: 33.96}  # tests/test_training.py::DERAIN_GOLDEN (0.15 dB there)
DERAIN_CROPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                            "derain_golden_crops.npz")
# a derain training step's gradients (deg_op, dgu, rhos) on the card against
# the CPU: max |card - CPU| / max |CPU| of each group, on a step from the
# shipped weights (the CPU's own gradients move <= 8e-5 there when the
# rainy input moves by 1e-6)
DERAIN_GRAD_REL_TOL = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, runs: int = 30, inner: int = 10, graph: bool = True) -> float:
    """Median over ``runs`` of the CUDA-event time of ``inner`` back-to-back
    calls, divided by ``inner``; inputs stay warm in L2. With ``graph``
    the calls are captured once in a CUDA graph and replayed, so the time
    is the device's without the host's per-call launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside any capture
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_per_s: float = PEAK_F32_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(kernels):
    t0 = time.perf_counter()
    report = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "tv_max_iterations": kernels.tv_max_iterations(), "kernels": report})


def phase_check(kernels, dev):
    """Kernel vs plain on the card; returns per-kernel measurements."""
    rng = np.random.RandomState(0)
    tv_cases = []
    # the flagship's shape (10 iterations), the joint paths' shape
    # (deep_prior(x, "tv") at 1x3x256x256 runs 5 iterations with one lam),
    # odd sizes, widths and heights on both sides of the kernel's windows
    # (128 columns; 32, 64, 96 rows), per-plane lam and 1..44 iterations:
    # bit for bit against the plain version in every window the count fits
    for shape, it, per_plane in TV_CASES:
        y = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        lam = torch.from_numpy(
            (0.02 + 0.1 * rng.rand(shape[0] if per_plane else 1)).astype(np.float32)).to(dev)
        got = kernels.tv_denoise_chw(y, lam, it)
        ref = kernels.tv_denoise_chw_plain(y, lam, it)
        fits = [i for i, (warps, rows) in enumerate(kernels.TV_WINDOWS) if warps * rows > 2 * it]
        same = [torch.equal(kernels._tv_launch(y, lam, it, i), ref) for i in fits]
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tv_cases.append({"shape": list(shape), "iterations": it, "lam_per_plane": per_plane,
                         "window": kernels.TV_WINDOWS[kernels.tv_window(*shape, it)],
                         "max_abs_err": err, "bit_equal": torch.equal(got, ref),
                         "every_window_bit_equal": all(same)})
        if not (err <= TV_TOL and torch.equal(got, ref) and all(same)):
            raise AssertionError(f"tv_denoise_chw {shape} it={it}: max|diff| {err} (limit "
                                 f"{TV_TOL}), not bit-equal to the plain version, or a "
                                 f"window differs: {dict(zip(fits, same))}")

    # the flagship's divide operands: |OTF|^2 of its PSF and one rho
    from dprox_tpu_torch.linop import Variable, conv
    from dprox_tpu_torch.utils.imaging import point_spread_function

    op = conv(Variable(), point_spread_function(15, 5)).to(dev)
    div_cases = []
    for B, per_batch, full_diag, strided in [(1, False, True, False), (2, True, True, False),
                                             (2, True, False, False), (1, False, True, True)]:
        shape = (B, 3, 512, 512)
        F = torch.from_numpy((rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)).to(dev)
        if strided:  # same values, H and W swapped in memory
            F = F.transpose(-1, -2).contiguous().transpose(-1, -2)
        diag = op.gram_diag(shape, freq=True) if full_diag else torch.ones((), device=dev)
        rho = torch.from_numpy((1e-5 * (1 + rng.rand(B if per_batch else 1))).astype(np.float32)).to(dev)
        rho = rho.reshape(-1, 1, 1, 1) if per_batch else rho.reshape(())
        got = kernels.freq_divide(F, diag, rho)
        ref = kernels.freq_divide_plain(F, diag, rho)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        div_cases.append({"shape": list(shape), "rho_per_batch": per_batch,
                          "diag": "full" if full_diag else "scalar", "F_strides": F.stride(),
                          "max_abs_err": err, "max_rel_err": rel})
        if not rel <= DIVIDE_REL_TOL:
            raise AssertionError(f"freq_divide {shape}: relative diff {rel} > {DIVIDE_REL_TOL}")
        if B == 1 and not strided:
            main_div = (F, diag, rho, err)

    # timings at the main path's shapes, and at the joint paths': the
    # window the kernel picks, and every window the count fits
    lam = torch.full((1,), 0.05, device=dev)
    tv_at = {}
    for shape, it in ((3, 512, 512), 10), ((3, 256, 256), 5):
        y = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        n = y.numel()
        b_tv = bound(2 * 4 * n + 4, n * (16 * (it - 1) + 6))
        window = kernels.tv_window(*shape, it)
        warps, rows = kernels.TV_WINDOWS[window]
        out_rows, out_cols = warps * rows - 2 * it, 128 - 2 * it
        tv_at[shape] = {
            "shape": list(shape), "iterations": it,
            "max_abs_err": next(c["max_abs_err"] for c in tv_cases
                                if c["shape"] == list(shape) and c["iterations"] == it),
            "ms": time_ms(lambda: kernels.tv_denoise_chw(y, lam, it)),
            "eager_ms": time_ms(lambda: kernels.tv_denoise_chw(y, lam, it), graph=False),
            "plain_ms": time_ms(lambda: kernels.tv_denoise_chw_plain(y, lam, it), 20, 2),
            "bound_ms": b_tv[0], "bound_by": b_tv[1],
            "window": [128, warps * rows],
            "recompute": 128 * warps * rows / (out_rows * out_cols),
            "blocks": shape[0] * -(-shape[1] // out_rows) * -(-shape[2] // out_cols),
            "ms_by_window": {f"128x{w_ * r_}": time_ms(lambda i=i: kernels._tv_launch(y, lam, it, i))
                             for i, (w_, r_) in enumerate(kernels.TV_WINDOWS)
                             if w_ * r_ > 2 * it}}
    main_tv = tv_at[(3, 512, 512)]
    tv = {"name": "tv_denoise_chw", "route": "cuda",
          "source": "dprox_tpu_torch/csrc/tv_denoise.cu",
          "replaces": "dprox_tpu/ops/pallas_kernels.py:388",
          **{k: main_tv[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
          "library_ms": None, "max_abs_err_all_cases": max(c["max_abs_err"] for c in tv_cases),
          "at_main_shape": main_tv, "at_joint_shape": tv_at[(3, 256, 256)]}
    F, diag, rho, err = main_div
    n = F.numel()
    div_bound = bound(8 * n + 4 * diag.numel() + 4 * rho.numel() + 8 * n, 6 * n)
    div = {"name": "freq_divide", "route": "cuda",
           "source": "dprox_tpu_torch/csrc/freq_divide.cu",
           "replaces": "dprox_tpu/ops/pallas_kernels.py:104",
           "max_abs_err": err,  # at the main path's shape; every case in the check line
           "ms": time_ms(lambda: kernels.freq_divide(F, diag, rho)),
           "plain_ms": time_ms(lambda: kernels.freq_divide_plain(F, diag, rho)),
           "bound_ms": div_bound[0], "bound_by": div_bound[1],
           "library_ms": time_ms(lambda: (F + 1e-7) / (diag + rho + 1e-7))}
    eager_ms = {"tv_denoise_chw": main_tv["eager_ms"],
                "freq_divide": time_ms(lambda: kernels.freq_divide(F, diag, rho), graph=False)}
    emit({"phase": "check", "tv_cases": tv_cases, "divide_cases": div_cases,
          "timing_shapes": {"tv_denoise_chw": [3, 512, 512, 10],
                            "tv_denoise_chw.at_joint_shape": [3, 256, 256, 5],
                            "freq_divide": [1, 3, 512, 512]},
          "timing": "CUDA-graph replay, median of 30 x 10 calls",
          "measured": [tv, div], "eager_ms_with_host_overhead": eager_ms})
    return [tv, div]


def flagship(dp, dev, size=512):
    from dprox_tpu_torch.utils.imaging import _synthetic_face, blurring, point_spread_function

    img = dp.tensor(_synthetic_face(size, size), batch=True, device=dev)
    psf = point_spread_function(15, 5)
    b = blurring(img, psf)
    x = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b),
                         dp.deep_prior(x, "distilled_color_tv")], "admm")
    return solver, img, b


def phase_main(dp, kernels, dev):
    from dprox_tpu_torch.utils.metrics import psnr

    solver, img, b = flagship(dp, dev)
    rhos, sigmas = dp.log_descent(80, 30, MAIN_ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = solver.solve(x0=b, max_iter=MAIN_ITERS, rhos=rhos, lams=sigmas)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if tuple(out.shape) != (1, 3, 512, 512) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad output: shape {tuple(out.shape)} or non-finite values")
    expected = dict.fromkeys(launches, 0) | {"tv_denoise_chw": MAIN_ITERS,
                                             "freq_divide": MAIN_ITERS}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    p_b, p_x = psnr(b, img), psnr(out, img)
    fft_strides = torch.fft.fftn(b, dim=(-2, -1)).stride()
    emit({"phase": "main", "config": "distilled_color_tv 1x3x512x512, log_descent(80, 30, 48)",
          "iterations": MAIN_ITERS, "first_solve_s": seconds, "launches": launches,
          "psnr_b": p_b, "psnr_x": p_x, "jax_cpu_psnr_b": JAX_CPU_PSNR_B,
          "jax_cpu_psnr_x": JAX_CPU_PSNR_X, "psnr_gap_db": p_x - JAX_CPU_PSNR_X,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "fft2_output_strides": fft_strides})
    if not p_x > p_b:
        raise AssertionError(f"PSNR did not rise: {p_x} <= {p_b}")
    if not abs(p_x - JAX_CPU_PSNR_X) <= PSNR_TOL_DB:
        raise AssertionError(f"PSNR {p_x} not within {PSNR_TOL_DB} dB of JAX-CPU {JAX_CPU_PSNR_X}")
    return solver, b, launches


def phase_marginal(dp, solver, b, card):
    rhos, sigmas = dp.log_descent(80, 30, MAIN_ITERS)

    def timed(n, reps=3):
        best = float("inf")
        for _ in range(reps + 1):  # the first run is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve(x0=b, max_iter=n, rhos=rhos[:n], lams=sigmas[:n])
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    obs = []
    for _ in range(3):
        t_lo, t_hi = timed(8), timed(MAIN_ITERS)
        obs.append((MAIN_ITERS - 8) / (t_hi - t_lo))

    # one iteration's stages at the main path's shapes: eager (host launch
    # overhead included, as in the solve loop) and, for the whole
    # iteration, device time from a CUDA-graph replay
    aux = solver.prepare_aux(b, {})
    state = solver.initialize(b, {})
    rho, lam = rhos[0].to(b.device), sigmas[0].to(b.device)
    denoiser = solver.psi_fns[0].denoiser
    sigma = lam.reshape(-1)
    v = state[1][0]
    shapes = solver._var_shapes(b)
    step = lambda: solver._iter(state, rho, [lam], 0, {}, aux)
    stages = {
        "iteration": time_ms(step, 10, 3, graph=False),
        "iteration_device": time_ms(step, 10, 3),
        "x_update": time_ms(lambda: solver.least_square.solve(
            [v], rho, var_shapes=shapes, prepared=aux.lsq), 20, 5, graph=False),
        "ffdnet": time_ms(lambda: denoiser.deep.denoise(v, sigma), 10, 3, graph=False),
        "tv_branch": time_ms(lambda: denoiser.tv.denoise(v, sigma), 20, 5, graph=False),
    }
    emit({"phase": "marginal", "its_per_sec": statistics.median(obs), "obs": obs,
          "span": f"8-{MAIN_ITERS}", "statistic": "median of 3 best-of-3",
          "stage_ms": stages, "card": card})
    return statistics.median(obs)


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)


def _best_ms(fn, reps=5):
    """Best host-clock time of ``fn`` in ms over ``reps`` runs after one
    warm-up, each ending in a device synchronise."""
    best = float("inf")
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def bdot_timing(kernels, p, q, err):
    """bdot's times on (p, q): graph replay, eager, plain version, one
    torch.linalg.vecdot call, and the bound (each operand read once, the
    output written once; a multiply and an add per element)."""
    n, item = p.numel(), p.element_size()
    b = bound(2 * item * n + item * p.shape[0], 2 * n,
              PEAK_F64_OPS_PER_S if p.dtype == torch.float64 else PEAK_F32_OPS_PER_S)
    return {"max_abs_err": err, "ms": time_ms(lambda: kernels.bdot(p, q)),
            "eager_ms": time_ms(lambda: kernels.bdot(p, q), graph=False),
            "plain_ms": time_ms(lambda: kernels.bdot_plain(p, q)),
            "bound_ms": b[0], "bound_by": b[1],
            "library_ms": time_ms(lambda: torch.linalg.vecdot(p.flatten(1), q.flatten(1)))}


def phase_check_solver_kernels(kernels, dev):
    """fused_admm_update, bdot and fused_cg_tail against their plain
    versions on the card; returns per-kernel measurements."""
    rng = np.random.RandomState(1)
    odd = [(2, 3, 37, 53), (4, 3, 37, 53), (1, 3, 37, 53), (2, 1, 1, 7)]

    admm_cases = []
    for shape in [(1, 3, 512, 512)] + odd:
        for kind in ("nonneg", "soft"):
            for per_batch in (False, True):
                Kx, u = _randn(rng, shape, dev), _randn(rng, shape, dev)
                Kx.view(-1)[0], u.view(-1)[0] = 0.0, 0.0  # sign(0) = 0
                lam = torch.from_numpy((0.1 + rng.rand(shape[0] if per_batch else 1))
                                       .astype(np.float32)).to(dev)
                got = kernels.fused_admm_update(Kx, u, lam, kind)
                ref = kernels.fused_admm_update_plain(Kx, u, lam, kind)
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                admm_cases.append({"shape": list(shape), "kind": kind,
                                   "lam_per_batch": per_batch, "max_abs_err": err})
                if err != 0.0:
                    raise AssertionError(f"fused_admm_update {shape} {kind}: max|diff| {err} != 0")

    # the paths' rows: B and B' (1x3x256x256), C and pretraining ([1, 8208]
    # LP variables), the chunked solve ([1, 32784]), the float64 solve
    # ([1, 520]) and consensus ([8, 520] scenarios); odd sizes; the path
    # C rows in float64 too
    bdot_cases = []
    f32, f64 = torch.float32, torch.float64
    for shape, dtype in ([((1, 3, 256, 256), f32), ((1, 3, 512, 512), f32)]
                         + [(s, f32) for s in odd]
                         + [(s, t) for s in BDOT_LP_ROWS for t in (f32, f64)]):
        a = torch.from_numpy(rng.randn(*shape)).to(device=dev, dtype=dtype)
        # <p, q> > 0, as <p, A p> for SPD A
        q = 1.5 * a + 0.1 * torch.from_numpy(rng.randn(*shape)).to(device=dev, dtype=dtype)
        got, again = kernels.bdot(a, q), kernels.bdot(a, q)
        ref = kernels.bdot_plain(a, q)
        exact = (a.double() * q.double()).flatten(1).sum(1)
        torch.cuda.synchronize()
        rel = float(((got - ref).abs() / ref.abs()).max())
        tol = REDUCE_REL_TOL if dtype == f32 else REDUCE_REL_TOL_F64
        bdot_cases.append({"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                           "max_rel_err": rel, "max_abs_err": float((got - ref).abs().max()),
                           "kernel_rel_gap_to_float64": float(((got - exact).abs() / exact.abs()).max()),
                           "plain_rel_gap_to_float64": float(((ref - exact).abs() / exact.abs()).max())})
        if not (rel <= tol and got.dtype == dtype):
            raise AssertionError(f"bdot {shape} {dtype}: relative diff {rel} > {tol}")
        if not torch.equal(got, again):
            raise AssertionError(f"bdot {shape} {dtype}: two calls gave different bits")

    tail_cases = []
    for shape in [(1, 3, 256, 256), (1, 3, 512, 512)] + odd + ["clamps"]:
        if shape == "clamps":  # row 0: <p, Ap> = 0; row 1: converged (r = p = 0, rs = 0)
            x, r, pp = (_randn(rng, (3, 3, 16, 20), dev) for _ in range(3))
            Ap = 2.0 * pp
            Ap[0], r[1], pp[1] = 0.0, 0.0, 0.0
            r[0] *= 1e-18
        else:
            x, r, pp = (_randn(rng, shape, dev) for _ in range(3))
            Ap = 1.5 * pp + 0.1 * _randn(rng, shape, dev)
        rs = kernels.bdot_plain(r, r)
        got, again = kernels.fused_cg_tail(x, r, pp, Ap, rs), kernels.fused_cg_tail(x, r, pp, Ap, rs)
        ref = kernels.fused_cg_tail_plain(x, r, pp, Ap, rs)
        rs64 = ((r.double() - (rs.double() / (pp.double() * Ap.double()).flatten(1).sum(1)
                               .clamp(min=1e-32)).reshape(-1, 1, 1, 1) * Ap.double()) ** 2
                ).flatten(1).sum(1)
        torch.cuda.synchronize()
        rels = [float((g - e).abs().max() / e.abs().max().clamp(min=1e-30)) for g, e in zip(got, ref)]
        case = {"shape": shape if shape == "clamps" else list(shape),
                "max_rel_err": dict(zip(("x", "r", "p", "rs"), rels)),
                "max_abs_err": max(float((g - e).abs().max()) for g, e in zip(got, ref)),
                "finite": all(bool(torch.isfinite(g).all()) for g in got)}
        if shape != "clamps":
            case["rs_kernel_rel_gap_to_float64"] = float(((got[3] - rs64).abs() / rs64).max())
            case["rs_plain_rel_gap_to_float64"] = float(((ref[3] - rs64).abs() / rs64).max())
        tail_cases.append(case)
        if not (max(rels) <= REDUCE_REL_TOL and case["finite"]):
            raise AssertionError(f"fused_cg_tail {shape}: relative diffs {rels} > {REDUCE_REL_TOL}")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"fused_cg_tail {shape}: two calls gave different bits")
        if shape == "clamps" and not (torch.equal(got[0][1], x[1]) and float(got[3][1]) == 0.0):
            raise AssertionError("fused_cg_tail moved a converged batch element")

    # timings at the paths' shapes: the update at path A's, bdot and the tail at path B's
    Kx, u = _randn(rng, (1, 3, 512, 512), dev), _randn(rng, (1, 3, 512, 512), dev)
    lam = torch.full((1,), 0.01, device=dev)
    n = Kx.numel()
    b_admm = bound(16 * n + 4, 4 * n)
    admm = {"name": "fused_admm_update", "route": "cuda",
            "source": "dprox_tpu_torch/csrc/fused_admm_update.cu",
            "replaces": "dprox_tpu/ops/pallas_kernels.py:64",
            "max_abs_err": admm_cases[0]["max_abs_err"],
            "ms": time_ms(lambda: kernels.fused_admm_update(Kx, u, lam, "nonneg")),
            "plain_ms": time_ms(lambda: kernels.fused_admm_update_plain(Kx, u, lam, "nonneg")),
            "bound_ms": b_admm[0], "bound_by": b_admm[1], "library_ms": None}
    x, r, pp = (_randn(rng, (1, 3, 256, 256), dev) for _ in range(3))
    Ap = 1.5 * pp + 0.1 * _randn(rng, (1, 3, 256, 256), dev)
    rs = kernels.bdot_plain(r, r)
    dot = {"name": "bdot", "route": "cuda", "source": "dprox_tpu_torch/csrc/bdot.cu",
           "replaces": "dprox_tpu/ops/pallas_kernels.py:227",
           **bdot_timing(kernels, pp, Ap, bdot_cases[0]["max_abs_err"]),
           "at_shapes": []}
    # every other row a path hands bdot, beside torch.linalg.vecdot and the bound
    for shape, dtype in [((1, 8208), f32), ((1, 32784), f32), ((1, 8208), f64),
                         ((1, 520), f64), ((8, 520), f32)]:
        a = torch.from_numpy(rng.randn(*shape)).to(device=dev, dtype=dtype)
        q = 1.5 * a + 0.1 * torch.from_numpy(rng.randn(*shape)).to(device=dev, dtype=dtype)
        err = next(c["max_abs_err"] for c in bdot_cases
                   if c["shape"] == list(shape) and c["dtype"] == str(dtype).replace("torch.", ""))
        dot["at_shapes"].append({"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
                                 **bdot_timing(kernels, a, q, err)})
    n = x.numel()
    b_tail = bound(28 * n + 8, 10 * n)
    tail = {"name": "fused_cg_tail", "route": "cuda",
            "source": "dprox_tpu_torch/csrc/cg_tail.cu",
            "replaces": "dprox_tpu/ops/pallas_kernels.py:291",
            "max_abs_err": tail_cases[0]["max_abs_err"],
            "ms": time_ms(lambda: kernels.fused_cg_tail(x, r, pp, Ap, rs)),
            "plain_ms": time_ms(lambda: kernels.fused_cg_tail_plain(x, r, pp, Ap, rs)),
            "bound_ms": b_tail[0], "bound_by": b_tail[1], "library_ms": None}
    x5, r5, p5, A5 = (_randn(rng, (1, 3, 512, 512), dev) for _ in range(4))
    rs5 = kernels.bdot_plain(r5, r5)
    extra = {"fused_cg_tail_1x3x512x512_ms": time_ms(lambda: kernels.fused_cg_tail(x5, r5, p5, A5, rs5)),
             "fused_cg_tail_1x3x512x512_bound_ms": bound(28 * x5.numel() + 8, 10 * x5.numel())[0],
             "fused_admm_update_soft_ms": time_ms(lambda: kernels.fused_admm_update(Kx, u, lam, "soft"))}
    eager_ms = {
        "fused_admm_update": time_ms(lambda: kernels.fused_admm_update(Kx, u, lam, "nonneg"), graph=False),
        "bdot": time_ms(lambda: kernels.bdot(pp, Ap), graph=False),
        "fused_cg_tail": time_ms(lambda: kernels.fused_cg_tail(x, r, pp, Ap, rs), graph=False)}
    emit({"phase": "check_solver_kernels", "admm_update_cases": admm_cases,
          "bdot_cases": bdot_cases, "cg_tail_cases": tail_cases,
          "timing_shapes": {"fused_admm_update": [1, 3, 512, 512], "bdot": [1, 3, 256, 256],
                            "fused_cg_tail": [1, 3, 256, 256]},
          "timing": "CUDA-graph replay, median of 30 x 10 calls (bdot's other rows in "
                    "its at_shapes, with eager_ms)",
          "measured": [admm, dot, tail], "other_shapes": extra,
          "eager_ms_with_host_overhead": eager_ms})
    return [admm, dot, tail]


def observation(size, psf, mosaic, dev):
    """(img, b) as 1x3xHxW tensors on ``dev``: the synthetic face cropped to
    ``size``, blurred with ``psf`` in float64 on the host and rounded to
    float32 (and Bayer-masked), so that the port sees the b the JAX
    package saw when the constants at the top were computed."""
    from dprox_tpu_torch.utils.fft import psf2otf
    from dprox_tpu_torch.utils.imaging import _synthetic_face, bayer_mask

    img = _synthetic_face(512, 512)[:size, :size].transpose(2, 0, 1)[None]
    otf = psf2otf(np.asarray(psf).squeeze(), (size, size))
    b = np.real(np.fft.ifft2(otf * np.fft.fft2(img.astype(np.float64)))).astype(np.float32)
    if mosaic:
        b = b * bayer_mask((size, size))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (img, b))


def _marginal(solve, lo, hi, reps, estimates):
    """Marginal iterations/s, (hi - lo) / (t_hi - t_lo), each t the best of
    ``reps`` solves after a warm-up; ``estimates`` such values."""
    obs = []
    for _ in range(estimates):
        t_lo, t_hi = _best_ms(lambda: solve(lo), reps), _best_ms(lambda: solve(hi), reps)
        obs.append((hi - lo) / ((t_hi - t_lo) * 1e-3))
    return obs


def phase_nonneg(dp, kernels, dev, card):
    from dprox_tpu_torch.algo.admm import ADMM
    from dprox_tpu_torch.utils.imaging import point_spread_function
    from dprox_tpu_torch.utils.metrics import psnr

    psf = point_spread_function(15, 5)
    img, b = observation(512, psf, False, dev)
    x = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b), dp.nonneg(x)], "admm")
    kw = {"rhos": 0.05, "lams": 0.01}
    _, res = solver.solve_with_residuals(x0=b, max_iter=NONNEG_CAP, **kw)
    rp, rd = res["r_primal"].cpu().numpy(), res["r_dual"].cpu().numpy()
    ok = np.where((rp < 1e-4) & (rd < 1e-4))[0]
    iters = int(ok[0]) + 1 if len(ok) else None
    n = JAX_CPU_NONNEG_ITERS
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = solver.solve(x0=b, max_iter=n, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    p_x = psnr(out, img)

    class GenericADMM(ADMM):  # every psi fn through fn.prox and the dual update
        _fused_kind = staticmethod(lambda fn, offset: None)

    bitwise = {}
    for name in ("nonneg", "norm1"):
        states = []
        for cls in (ADMM, GenericADMM):
            xv = dp.Variable()
            fns = [dp.sum_squares(dp.conv(xv, psf) - b), 2.0 * getattr(dp, name)(xv)]
            last = {}
            cls(*cls.partition(fns)).solve(
                x0=b, max_iter=5, callback=lambda iter, state, rho, lam: last.update(s=state), **kw)
            states.append((last["s"][0], last["s"][1][0], last["s"][2][0]))
        bitwise[name] = all(torch.equal(f, g) for f, g in zip(*states))

    obs = _marginal(lambda k: solver.solve(x0=b, max_iter=k, **kw), 24, 224, reps=5, estimates=3)
    aux = solver.prepare_aux(b, {})
    state = solver.initialize(b, {})
    rho = torch.tensor(0.05, device=dev)
    lam = torch.tensor(0.01, device=dev)
    x_update = lambda: solver.least_square.solve(
        [state[1][0]], rho, var_shapes=solver._var_shapes(b), prepared=aux.lsq)
    xu = x_update()
    step = lambda: solver._iter(state, rho, [lam], 0, {}, aux)
    stages = {
        "iteration": time_ms(step, 20, 5, graph=False),
        "iteration_device": time_ms(step, 20, 5),
        "x_update": time_ms(x_update, 20, 5, graph=False),
        "x_update_device": time_ms(x_update, 20, 5),
        "contiguous_copy_of_x": time_ms(lambda: xu.contiguous(), 20, 5, graph=False),
        "fused_admm_update": time_ms(lambda: kernels.fused_admm_update(
            state[1][0], state[2][0], lam, "nonneg"), 20, 5, graph=False),
    }
    emit({"phase": "nonneg", "config": "sum_squares(conv(x, psf(15, 5)) - b) + nonneg(x), "
          "1x3x512x512, rhos 0.05, lams 0.01", "iters_to_pd_residual_1e-4": iters,
          "jax_cpu_iters": n, "residuals_at_jax_cpu_iters": [float(rp[n - 1]), float(rd[n - 1])],
          "solve_iterations": n, "solve_s": seconds, "launches": launches,
          "psnr_b": psnr(b, img), "psnr_x": p_x, "jax_cpu_psnr_x": JAX_CPU_NONNEG_PSNR_X,
          "psnr_gap_db": p_x - JAX_CPU_NONNEG_PSNR_X,
          "fused_route_equals_generic_route_after_5_iterations": bitwise,
          "x_update_output_is_contiguous": xu.is_contiguous(),
          "its_per_sec": statistics.median(obs), "obs": obs, "span": "24-224",
          "statistic": "median of 3 best-of-5",
          "stage_ms": stages, "card": card})
    if iters is None or abs(iters - n) > 1:
        raise AssertionError(f"iterations to 1e-4: {iters}, JAX-CPU {n} (allowed +-1)")
    expected = dict.fromkeys(launches, 0) | {"fused_admm_update": n, "freq_divide": n}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if tuple(out.shape) != (1, 3, 512, 512) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad output: shape {tuple(out.shape)} or non-finite values")
    if not abs(p_x - JAX_CPU_NONNEG_PSNR_X) <= PSNR_TOL_DB:
        raise AssertionError(f"PSNR {p_x} not within {PSNR_TOL_DB} dB of JAX-CPU "
                             f"{JAX_CPU_NONNEG_PSNR_X}")
    if not all(bitwise.values()):
        raise AssertionError(f"fused ADMM route differs from the generic route: {bitwise}")
    return launches


def phase_joint(dp, kernels, dev, card):
    from dprox_tpu_torch.linalg import solvers
    from dprox_tpu_torch.utils.imaging import point_spread_function
    from dprox_tpu_torch.utils.metrics import psnr

    psf = point_spread_function(9, 2)
    img, b = observation(256, psf, True, dev)
    init = dp.utils.demosaic_from_mosaiced(b)
    p_init = psnr(init, img)
    rhos, sigmas = dp.log_descent(35, 10, JOINT_ITERS)
    configs = {"cg_pallas": dp.LinearSolveConfig(max_iters=40, solver_type="cg_pallas"),
               "default_pcg": dp.LinearSolveConfig(max_iters=40)}
    results, launches_by_config = {}, {}
    for name, cfg in configs.items():
        x = dp.Variable()
        data = dp.sum_squares(dp.mosaic(dp.conv(x, psf)) - dp.Placeholder("b"))
        solver = dp.compile(data + dp.deep_prior(x, "tv"), "admm", linear_solve_config=cfg)

        def solve(k):
            return solver.solve(x0=init, max_iter=k, rhos=rhos[:k], lams=sigmas[:k],
                                params={"b": b})

        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = solve(JOINT_ITERS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        # inner CG iterations of the 24 x-updates, from the counts: cg_pallas
        # launches one tail per inner iteration (and bdot twice per set-up),
        # pcg launches bdot once per set-up and twice per inner iteration
        if name == "cg_pallas":
            inner, odd = launches["fused_cg_tail"], 0
            expected = dict.fromkeys(launches, 0) | {
                "fused_cg_tail": inner, "bdot": 2 * JOINT_ITERS, "tv_denoise_chw": JOINT_ITERS}
        else:
            inner, odd = divmod(launches["bdot"] - JOINT_ITERS, 2)
            expected = dict.fromkeys(launches, 0) | {
                "bdot": launches["bdot"], "tv_denoise_chw": JOINT_ITERS}
        p_x = psnr(out, img)
        obs = _marginal(solve, 4, JOINT_ITERS, reps=3, estimates=3)
        results[name] = {"inner_iterations": inner, "launches": launches, "solve_s": seconds,
                         "psnr_x": p_x, "jax_cpu_psnr_x": JAX_CPU_JOINT_PSNR_X[name],
                         "psnr_gap_db": p_x - JAX_CPU_JOINT_PSNR_X[name],
                         "outer_its_per_sec": statistics.median(obs), "obs": obs}
        launches_by_config[name] = launches
        if name == "cg_pallas":
            # one x-update's stages at rho of the middle iteration: the matvec
            # K^T K + rho as solve_cg builds it, 40 tail iterations with the
            # stop test's host read (rtol = 0 never stops early) and without
            fn, rho = solver.omega_fns[0], rhos[JOINT_ITERS // 2].to(dev)
            params = {"b": b}
            A = lambda v: (0.0 + fn.dag_adjoint(fn.dag_forward(v, params), params)) + rho * v
            rhs = fn.dag_adjoint(b, params) + rho * init

            def tails_without_stop_test():
                xk = torch.zeros_like(rhs)
                r = rhs - A(xk)
                pk, rs = r, solvers.bdot(r, r)
                solvers.bdot(rhs, rhs)
                for _ in range(40):
                    xk, r, pk, rs = kernels.fused_cg_tail(xk, r, pk, A(pk).contiguous(), rs)
                return xk

            with_test = _best_ms(lambda: solvers.cg_pallas(A, rhs, rtol=0.0, max_iters=40))
            without = _best_ms(tails_without_stop_test)
            r0 = rhs - A(torch.zeros_like(rhs))
            rs0 = solvers.bdot(r0, r0)
            Ap0 = A(r0).contiguous()
            results[name]["x_update_stage_ms"] = {
                "cg_pallas_40_iterations_with_stop_test": with_test,
                "same_40_tails_without_stop_test": without,
                "stop_test_per_iteration": (with_test - without) / 40,
                "matvec": time_ms(lambda: A(r0), 20, 5, graph=False),
                "matvec_device": time_ms(lambda: A(r0), 20, 5),
                "fused_cg_tail": time_ms(lambda: kernels.fused_cg_tail(
                    torch.zeros_like(r0), r0, r0, Ap0, rs0), 20, 5, graph=False),
                "tv_prior": time_ms(lambda: solver.psi_fns[0].denoiser.denoise(
                    init, sigmas[0].to(dev).reshape(-1)), 20, 5, graph=False)}
        if launches != expected or odd or not 0 < inner <= 40 * JOINT_ITERS:
            raise AssertionError(f"{name}: launch counts {launches} != {expected} "
                                 f"(inner iterations {inner}, cap {40 * JOINT_ITERS})")
        if tuple(out.shape) != (1, 3, 256, 256) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: bad output shape {tuple(out.shape)} or non-finite")
        if not abs(p_x - JAX_CPU_JOINT_PSNR_X[name]) <= PSNR_TOL_DB or not p_x > p_init:
            raise AssertionError(f"{name}: PSNR {p_x} (init {p_init}) not within {PSNR_TOL_DB} "
                                 f"dB of JAX-CPU {JAX_CPU_JOINT_PSNR_X[name]}")
    emit({"phase": "joint", "config": "sum_squares(mosaic(conv(x, psf(9, 2))) - b) + "
          "deep_prior(x, 'tv'), 1x3x256x256, log_descent(35, 10, 24), CG max_iters 40",
          "outer_iterations": JOINT_ITERS, "psnr_init": p_init,
          "jax_cpu_psnr_init": JAX_CPU_JOINT_PSNR_INIT, "span": f"4-{JOINT_ITERS}",
          "statistic": "median of 3 best-of-3", "configs": results, "card": card})
    if not abs(p_init - JAX_CPU_JOINT_PSNR_INIT) <= PSNR_TOL_DB:
        raise AssertionError(f"init PSNR {p_init} vs JAX-CPU {JAX_CPU_JOINT_PSNR_INIT}")
    return launches_by_config


def phase_grad(dp, kernels, dev, card):
    """Gradients through the kernels' autograd Functions on the card: d loss
    / d (rhos, lams) of a short unrolled admm solve at 1x3x256x256 with
    norm1(grad(x)) (freq_divide, fused_admm_update) and with the TV prior
    (freq_divide, tv_denoise_chw), and d loss / d (rho, b) of cg_pallas
    called directly (fused_cg_tail, bdot), each against the same
    computation with device="cpu" (the plain versions)."""
    from dprox_tpu_torch.linalg import solvers
    from dprox_tpu_torch.utils.imaging import point_spread_function

    rhos0 = [0.05, 0.04, 0.06, 0.05, 0.03]
    lams0 = [0.01, 0.02, 0.015, 0.01, 0.012]

    def admm_grads(device, prior):
        psf = point_spread_function(15, 5)
        img, b = observation(256, psf, False, device)
        x = dp.Variable()
        reg = dp.norm1(dp.grad(x)) if prior == "norm1" else dp.deep_prior(x, "tv")
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b), reg], "admm", device=device)
        rhos = torch.tensor(rhos0, device=device, requires_grad=True)
        lams = torch.tensor(lams0, device=device, requires_grad=True)
        out = solver.solve(x0=b, max_iter=len(rhos0), rhos=rhos, lams=lams)
        loss = torch.mean((out - img) ** 2)
        return out.grad_fn is not None, torch.autograd.grad(loss, (rhos, lams))

    def cg_grads(device):
        psf = point_spread_function(9, 2)
        img, b = observation(256, psf, True, device)
        init = dp.utils.demosaic_from_mosaiced(b)
        x = dp.Variable()
        data = dp.sum_squares(dp.mosaic(dp.conv(x, psf)) - dp.Placeholder("b"))
        solver = dp.compile(data + dp.deep_prior(x, "tv"), "admm", device=device,
                            linear_solve_config=dp.LinearSolveConfig(max_iters=40,
                                                                     solver_type="cg_pallas"))
        fn = solver.omega_fns[0]
        rho = torch.tensor(0.3, device=device, requires_grad=True)
        b = b.clone().requires_grad_()
        A = lambda v: fn.dag_adjoint(fn.dag_forward(v, {"b": b}), {"b": b}) + rho * v
        rhs = fn.dag_adjoint(b, {"b": b}) + rho * init
        out = solvers.cg_pallas(A, rhs, rtol=0.0, max_iters=10)
        loss = torch.mean((out - img) ** 2)
        return out.grad_fn is not None, torch.autograd.grad(loss, (rho, b))

    runs = {"admm_norm1": (lambda d: admm_grads(d, "norm1"), ("rhos", "lams"),
                           ("freq_divide", "fused_admm_update")),
            "admm_tv": (lambda d: admm_grads(d, "tv"), ("rhos", "lams"),
                        ("freq_divide", "tv_denoise_chw")),
            "cg_pallas": (cg_grads, ("rho", "b"), ("fused_cg_tail", "bdot"))}
    results, failed = {}, []
    for name, (run, wrt, kernels_used) in runs.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        has_graph, got = run(dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        _, ref = run("cpu")
        rel = {w: float((g.cpu().double() - r.double()).abs().max()
                        / r.double().abs().max().clamp(min=1e-300))
               for w, g, r in zip(wrt, got, ref)}
        results[name] = {"wrt": list(wrt), "max_rel_err_vs_cpu": rel,
                         "grad_abs_sum": {w: float(g.abs().sum()) for w, g in zip(wrt, got)},
                         "finite": all(bool(torch.isfinite(g).all()) for g in got),
                         "output_has_grad_fn": has_graph, "seconds": seconds,
                         "launches": {k: launches[k] for k in kernels_used}}
        r = results[name]
        if not (has_graph and r["finite"] and all(v > 0 for v in r["grad_abs_sum"].values())
                and all(v <= GRAD_REL_TOL for v in rel.values())
                and all(v > 0 for v in r["launches"].values())):
            failed.append(name)
    emit({"phase": "grad", "config": "1x3x256x256; admm, 5 iterations, loss mean((x - img)^2) "
          "w.r.t. the rhos and lams schedules; cg_pallas 10 iterations (rtol 0) on the joint "
          "operator K^T K + rho, w.r.t. rho and b", "tolerance": GRAD_REL_TOL,
          "of": "max |g_cuda - g_cpu| / max |g_cpu|", "runs": results, "card": card})
    if failed:
        raise AssertionError(f"grad: {failed} missing, zero, non-finite, more than "
                             f"{GRAD_REL_TOL} off the CPU, or launched no kernel")


def equilibrated_cep(n_periods, n_tech):
    """The Ruiz-equilibrated stacked constraint matrix [A_ub; A_eq; I] of
    synthetic_cep_model(n_periods, n_tech) as LPProblem builds it (scipy CSR,
    float64)."""
    from dprox_tpu_torch.algo.lp import LPProblem
    from dprox_tpu_torch.contrib.energy_system import synthetic_cep_model

    c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(n_periods, n_tech)
    return LPProblem(c, A_ub, b_ub, A_eq, b_eq, dtype=torch.float32).A_host


def arrow(n_blocks, b, seed=0):
    """Block-angular (arrow) matrix, scipy CSR: dense b x b diagonal blocks
    and a dense first block column, entries in [0.5, 1.5); 2 n_blocks - 1
    tiles of b x b."""
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    dense = lambda: sp.csr_matrix(0.5 + rng.rand(b, b))
    grid = [[None] * n_blocks for _ in range(n_blocks)]
    for i in range(n_blocks):
        grid[i][i] = dense()
        if i:
            grid[i][0] = dense()
    return sp.bmat(grid, format="csr")


def long_rows(rng):
    """6000 x 5000 random rows (~10 non-zeros) with rows of 4500, 2000 and
    129 non-zeros and a column of 5000: each direction has a row longer
    than CSR_CHUNK (4096) to cut into pieces."""
    import scipy.sparse as sp

    A = sp.random(6000, 5000, density=0.002, random_state=rng, format="lil")
    for r, k in [(6, 4500), (7, 2000), (8, 129)]:
        A[r, rng.choice(5000, k, replace=False)] = 1.0 + rng.rand(k)
    A[rng.choice(6000, 5000, replace=False), 11] = 1.0 + rng.rand(5000)[:, None]
    return sp.csr_matrix(A)


def _routes(kernels, op, A, transposed, dtype, dev):
    """Both routes' kernel arguments for one direction of a BSRMat: the
    tiles with their row_ptr, and the compressed rows of the same matrix
    from scipy with their split (on the compressed route, equal to the
    operator's own: checked)."""
    import scipy.sparse as sp

    M = sp.csr_matrix(A.T if transposed else A, copy=True)
    M.eliminate_zeros()
    M.sort_indices()
    if transposed:
        tiles, idx_in, idx_out, ptr, n_in = op.tilesT, op.row_idsT, op.col_idsT, op.row_ptrT, op.Mb
    else:
        tiles, idx_in, idx_out, ptr, n_in = op.tiles, op.col_ids, op.row_ids, op.row_ptr, op.Nb
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)
    csr = (put(M.indptr, torch.int32), put(M.indices, torch.int32), put(M.data, dtype))
    if op.route == "csr":
        own = op.csrT if transposed else op.csr
        if not all(torch.equal(a, b) for a, b in zip(own[:3], csr)):
            raise AssertionError("BSRMat's compressed rows differ from scipy's")
        csplit = own[3]
    else:
        csplit = kernels.csr_split(csr[0], dev)
    n_out = ptr.numel() - 1
    return M, (tiles, idx_in, idx_out, n_in, n_out, ptr), csr + (csplit,)


def _spmv_case(kernels, route, args, v, M, dtype, dev):
    """One kernel call twice and its plain version on float64 copies of the
    same inputs, on the card: (got, again, ref) as flat vectors of M's row
    count."""
    if route == "tiles":
        tiles, idx_in, idx_out, n_in, n_out, ptr = args
        vb = torch.zeros(n_in * tiles.shape[2], dtype=dtype, device=dev)
        vb[:v.numel()] = v
        vb = vb.reshape(n_in, -1)
        run = lambda: kernels.bsr_matvec(tiles, idx_in, idx_out, vb, n_out, row_ptr=ptr)
        plain = kernels.bsr_matvec_plain(tiles.double(), idx_in, idx_out, vb.double(), n_out)
        got, again = run(), run()
        pad = got.reshape(-1)[M.shape[0]:]
        if pad.numel() and float(pad.abs().max()) != 0.0:
            raise AssertionError("bsr_matvec: padding rows are not zero")
        flat = lambda t: t.reshape(-1)[:M.shape[0]]
        return flat(got), flat(again), flat(plain)
    indptr, indices, values, split = args
    run = lambda: kernels.csr_matvec(indptr, indices, values, v, split)
    return run(), run(), kernels.csr_matvec_plain(indptr, indices, values.double(),
                                                  v.double(), split)


def phase_check_bsr(kernels, dev):
    """Both routes of the LP operator, bsr_matvec (dense tiles) and
    csr_matvec (compressed rows), in float32 and float64, forward,
    transposed and backward, and the float64 bdot, against their plain
    versions and scipy on the card; returns both kernels' measurements at
    the LP path's shapes and at a block-dense operator's."""
    import scipy.sparse as sp

    from dprox_tpu_torch.algo.lp import BSRMat

    rng = np.random.RandomState(2)
    with_empty_rows = sp.lil_matrix((5 * 128, 300))
    with_empty_rows[0:40, 0:290] = rng.rand(40, 290)
    with_empty_rows[520:640, 130:300] = rng.rand(120, 170)  # row blocks 1..3 stay empty
    random = lambda m, n: sp.random(m, n, density=0.05, random_state=rng, format="csr")
    A_lp, A_big, A_arrow = equilibrated_cep(512, 16), equilibrated_cep(2048, 16), arrow(64, 128)
    matrices = [("cep(512,16)", A_lp, 128, 128), ("cep(2048,16)", A_big, 128, 128),
                ("arrow 64x128", A_arrow, 128, 128),
                ("random 70x33", random(70, 33), 128, 128),
                ("random 256x300", random(256, 300), 128, 128),
                ("random 13x513", random(13, 513), 128, 128),
                ("empty output block rows 640x300", with_empty_rows.tocsr(), 128, 128),
                ("random 150x90, bm=32 bn=16", random(150, 90), 32, 16),
                ("random 90x150, bm=48 bn=200", random(90, 150), 48, 200),
                ("long rows 6000x5000", long_rows(rng), 128, 128)]
    cases, routes, timed = [], {}, {}
    for name, A, bm, bn in matrices:
        for dtype in (torch.float32, torch.float64):
            op = BSRMat(A, bm=bm, bn=bn, dtype=dtype, device=dev)
            routes[name] = op.route
            for direction in ("forward", "transposed"):
                M, tile_args, csr_args = _routes(kernels, op, A, direction == "transposed",
                                                 dtype, dev)
                v = torch.from_numpy(rng.rand(M.shape[1])).to(device=dev, dtype=dtype)
                exact = M @ v.double().cpu().numpy()
                for route, args in (("tiles", tile_args), ("csr", csr_args)):
                    got, again, ref = _spmv_case(kernels, route, args, v, M, dtype, dev)
                    torch.cuda.synchronize()
                    err = float((got.double() - ref).abs().max())
                    rel = err / max(float(ref.abs().max()), 1e-300)
                    rel_scipy = float(np.abs(got.double().cpu().numpy() - exact).max()
                                      / max(np.abs(exact).max(), 1e-300))
                    case = {"matrix": name, "shape": list(A.shape), "tiles": op.n_tiles,
                            "nnz": int(M.nnz), "blocks": [bm, bn],
                            "dtype": str(dtype).replace("torch.", ""), "direction": direction,
                            "route": route, "max_abs_err": err, "max_rel_err": rel,
                            "max_rel_err_vs_scipy_float64": rel_scipy}
                    if route == "csr":
                        case["cut_rows"] = args[-1].n_split
                    cases.append(case)
                    what = f"{route} {name} {case['dtype']} {direction}"
                    if not rel <= SPMV_REL_TOL[dtype]:
                        raise AssertionError(f"{what}: relative diff {rel} > {SPMV_REL_TOL[dtype]}")
                    if not rel_scipy <= SPMV_SCIPY_REL_TOL[dtype]:
                        raise AssertionError(f"{what}: relative diff to scipy {rel_scipy} > "
                                             f"{SPMV_SCIPY_REL_TOL[dtype]}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"{what}: two calls gave different bits")
                if dtype == torch.float32 and name.startswith(("cep", "arrow")):
                    timed[(name, direction)] = (op, M, tile_args, csr_args, v)
            if name.startswith("empty") and float((op @ torch.ones(300, dtype=dtype, device=dev))
                                                  [128:512].abs().max()) != 0.0:
                raise AssertionError("an output block without tiles is not zero")

    # the backward on the card: grad of sum((A x)^2) = 2 A^T A x, and of A^T,
    # in exactly two launches of the route's kernel
    backward = []
    for name, A, dtype, tol, b in [("cep(512,16)", A_lp, torch.float32, 1e-4, 128),
                                   ("cep(512,16)", A_lp, torch.float64, 1e-10, 128),
                                   ("random 40x30, bm=bn=16",
                                    sp.random(40, 30, density=0.2, random_state=rng,
                                              format="csr"), torch.float64, 1e-10, 16),
                                   ("arrow 8x16, bm=bn=16", arrow(8, 16, seed=3),
                                    torch.float64, 1e-10, 16)]:
        op = BSRMat(A, bm=b, bn=b, dtype=dtype, device=dev)
        counter = kernels.csr_matvec if op.route == "csr" else kernels.bsr_matvec
        for M, apply in ((A, lambda t: op @ t), (A.T.tocsr(), lambda t: op.T @ t)):
            x0 = rng.rand(M.shape[1])
            x = torch.from_numpy(x0).to(device=dev, dtype=dtype).requires_grad_()
            before = counter.launches
            g, = torch.autograd.grad(torch.sum(apply(x) ** 2), x)
            launched = counter.launches - before
            exact = 2 * (M.T @ (M @ x0))
            rel = float(np.abs(g.double().cpu().numpy() - exact).max() / np.abs(exact).max())
            backward.append({"matrix": name, "dtype": str(dtype).replace("torch.", ""),
                             "route": op.route, "operator": "A" if M is A else "A^T",
                             "max_rel_err": rel, "launches": launched})
            if not rel <= tol or launched != 2:
                raise AssertionError(f"{op.route} backward {name} {dtype}: relative diff {rel} "
                                     f"> {tol} or {launched} launches != 2")

    bdot64 = []
    for shape in [(1, 8208), (8, 520), (2, 3, 37, 53), (1, 3, 256, 256)]:
        a = torch.from_numpy(rng.randn(*shape)).to(dev)
        q = 1.5 * a + 0.1 * torch.from_numpy(rng.randn(*shape)).to(dev)
        got, again = kernels.bdot(a, q), kernels.bdot(a, q)
        ref = kernels.bdot_plain(a, q)
        torch.cuda.synchronize()
        rel = float(((got - ref).abs() / ref.abs()).max())
        bdot64.append({"shape": list(shape), "max_rel_err": rel})
        if not (rel <= 1e-12 and got.dtype == torch.float64 and torch.equal(got, again)):
            raise AssertionError(f"bdot float64 {shape}: relative diff {rel} > 1e-12")
    # bdot is differentiable on the card: d<p, q>/dp = q, d/dq = p
    a = torch.from_numpy(rng.randn(2, 8208).astype(np.float32)).to(dev).requires_grad_()
    q = torch.from_numpy(rng.randn(2, 8208).astype(np.float32)).to(dev).requires_grad_()
    ga, gq = torch.autograd.grad(kernels.bdot(a, q).sum(), (a, q))
    if not (torch.equal(ga, q.detach()) and torch.equal(gq, a.detach())):
        raise AssertionError("bdot on the card: wrong gradient")

    # timings, float32, both routes and directions of the two LP operators
    # and the arrow operator; the library call is torch.sparse's CSR product
    # of the same matrix with the same vector; each bound counts the route's
    # own bytes (every array read once, y written once)
    rows = []
    for (name, direction), (op, M, tile_args, csr_args, v) in timed.items():
        lib = torch.sparse_csr_tensor(*csr_args[:3], size=M.shape).to(dev)
        tiles, idx_in, idx_out, n_in, n_out, ptr = tile_args
        vb = torch.zeros(n_in * tiles.shape[2], device=dev)
        vb[:v.numel()] = v
        vb = vb.reshape(n_in, -1)
        indptr, indices, values, csplit = csr_args
        T, bm_, bn_ = tiles.shape
        item = 4
        tile_bytes = (T * bm_ * bn_ * item + vb.numel() * item + n_out * bm_ * item
                      + 4 * (T + n_out + 1))
        csr_bytes = M.nnz * (item + 4) + (M.shape[0] + 1) * 4 + sum(M.shape) * item
        apply = (lambda: op.T @ v) if direction == "transposed" else (lambda: op @ v)
        library_ms = time_ms(lambda: lib @ v)
        for route, launch, plain, nbytes, ops in [
                ("tiles", lambda: kernels.bsr_matvec(tiles, idx_in, idx_out, vb, n_out,
                                                     row_ptr=ptr),
                 lambda: kernels.bsr_matvec_plain(tiles, idx_in, idx_out, vb, n_out),
                 tile_bytes, 2 * T * bm_ * bn_),
                ("csr", lambda: kernels.csr_matvec(indptr, indices, values, v, csplit),
                 lambda: kernels.csr_matvec_plain(indptr, indices, values, v, csplit),
                 csr_bytes, 2 * M.nnz)]:
            b_route = bound(nbytes, ops)
            err = next(c["max_abs_err"] for c in cases
                       if (c["matrix"], c["direction"], c["route"], c["dtype"])
                       == (name, direction, route, "float32"))
            rows.append({"matrix": name, "shape": list(M.shape), "nnz": int(M.nnz),
                         "tiles": T, "direction": direction, "route": route,
                         "operator_route": op.route, "max_abs_err": err, "ms": time_ms(launch),
                         "eager_ms": time_ms(launch, graph=False),
                         "plain_ms": time_ms(plain), "library_ms": library_ms,
                         "bound_ms": b_route[0], "bound_by": b_route[1], "bytes": nbytes})
        rows[-1]["operator_eager_ms"] = time_ms(apply, graph=False)
    pick = lambda name, direction, route: next(
        r for r in rows if (r["matrix"], r["direction"], r["route"]) == (name, direction, route))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    bsr = {"name": "bsr_matvec", "route": "cuda",
           "source": "dprox_tpu_torch/csrc/bsr_matvec.cu",
           "replaces": "dprox_tpu/ops/pallas_kernels.py:173",
           **{k: pick("cep(512,16)", "forward", "tiles")[k] for k in keys},
           "shape": "cep(512,16) forward (the LP operator, which takes the csr route; "
                    "no workload of the repo takes the tile route)",
           "library": "torch.sparse CSR A @ x (float32) of the same matrix",
           "at_shapes": [r for r in rows if r["route"] == "tiles"]}
    csr = {"name": "csr_matvec", "route": "cuda",
           "source": "dprox_tpu_torch/csrc/csr_matvec.cu",
           "replaces": "dprox_tpu/ops/pallas_kernels.py:173",
           **{k: pick("cep(512,16)", "forward", "csr")[k] for k in keys},
           "shape": "cep(512,16) forward (the LP path's operator)",
           "library": "torch.sparse CSR A @ x (float32) of the same matrix",
           "at_shapes": [r for r in rows if r["route"] == "csr"]}
    # graph-replay ms of the transposed apply over the forward one, and of
    # the compressed kernel over the library call, on each operator's route
    ratios = {name: {"route": routes[name],
                     "transposed_over_forward": pick(name, "transposed", routes[name])["ms"]
                     / pick(name, "forward", routes[name])["ms"],
                     "csr_over_library": {d: pick(name, d, "csr")["ms"]
                                          / pick(name, d, "csr")["library_ms"]
                                          for d in ("forward", "transposed")}}
              for name in ("cep(512,16)", "cep(2048,16)", "arrow 64x128")}
    emit({"phase": "check_bsr", "routes": routes, "ratios": ratios, "cases": cases,
          "backward_cases": backward,
          "bdot_float64_cases": bdot64,
          "tolerance": {"float32": SPMV_REL_TOL[torch.float32],
                        "float64": SPMV_REL_TOL[torch.float64],
                        "of": "max |kernel - plain| / max |plain|, plain on float64 copies"},
          "csr_split": {"short_row": kernels.CSR_SHORT_ROW, "warp_row": kernels.CSR_WARP_ROW,
                        "chunk": kernels.CSR_CHUNK},
          "timing": "CUDA-graph replay (ms) and eager calls (eager_ms), median of 30 x 10 "
                    "calls, float32; the 2048-period operator's 85 MB of tiles per direction "
                    "exceed the 50 MB L2",
          "measured": [bsr, csr]})
    return [bsr, csr]


def phase_kernels_per_call(kernels, dev):
    """Device kernels per call of each wrapper, from a torch.profiler trace
    of ten calls at a path's shape. bdot's and fused_cg_tail's must match
    their design: one block a row at path C's [1, 8208] (1), blocks spread
    over the card and a dependent finish at 1x3x256x256 (2), and the CG
    tail's three dependent launches (3)."""
    from collections import Counter

    import scipy.sparse as sp
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dprox_tpu_torch.algo.lp import BSRMat

    rng = np.random.RandomState(4)
    y = torch.from_numpy(rng.rand(3, 256, 256).astype(np.float32)).to(dev)
    y512 = torch.from_numpy(rng.rand(3, 512, 512).astype(np.float32)).to(dev)
    lam = torch.full((1,), 0.05, device=dev)
    F = torch.from_numpy((rng.randn(1, 3, 256, 256) + 1j * rng.randn(1, 3, 256, 256))
                         .astype(np.complex64)).to(dev)
    one = torch.ones((), device=dev)
    x, r, pp, Ap = (_randn(rng, (1, 3, 256, 256), dev) for _ in range(4))
    rs = kernels.bdot_plain(r, r)
    v = _randn(rng, (1, 8208), dev)
    A = sp.random(1000, 700, density=0.02, random_state=rng, format="csr")
    op = BSRMat(A, dtype=torch.float32, device=dev)
    x700 = torch.from_numpy(rng.rand(700).astype(np.float32)).to(dev)
    xb = torch.zeros(op.Nb * op.tiles.shape[2], device=dev)
    xb[:700] = x700
    xb = xb.reshape(op.Nb, -1)
    calls = {
        "tv_denoise_chw": lambda: kernels.tv_denoise_chw(y, lam, 5),
        "tv_denoise_chw 3x512x512x10": lambda: kernels.tv_denoise_chw(y512, lam, 10),
        "freq_divide": lambda: kernels.freq_divide(F, one, one),
        "fused_admm_update": lambda: kernels.fused_admm_update(x, r, lam, "nonneg"),
        "bdot": lambda: kernels.bdot(v, v),
        "bdot 1x3x256x256": lambda: kernels.bdot(pp, Ap),
        "fused_cg_tail": lambda: kernels.fused_cg_tail(x, r, pp, Ap, rs),
        "csr_matvec": lambda: kernels.csr_matvec(*op.csr[:3], x700, op.csr[3]),
        "bsr_matvec": lambda: kernels.bsr_matvec(op.tiles, op.col_ids, op.row_ids, xb, op.Mb,
                                                 row_ptr=op.row_ptr),
    }
    per_call, seen = {}, 0
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        names = Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                        and not e.name.startswith(("Memcpy", "Memset")))
        seen += sum(names.values())
        per_call[name] = {"kernels_per_call": sum(names.values()) / 10,
                          "names": {k: c / 10 for k, c in names.items()}}
    emit({"phase": "kernels_per_call", "calls": 10,
          "trace": "torch.profiler, CUDA activity" if seen else
                   "the profiler recorded no device events: kernels per call not measured",
          "per_call": per_call if seen else None})
    if seen:
        for name, want in (("bdot", 1), ("bdot 1x3x256x256", 2), ("fused_cg_tail", 3),
                           ("tv_denoise_chw", 1), ("tv_denoise_chw 3x512x512x10", 1)):
            if per_call[name]["kernels_per_call"] != want:
                raise AssertionError(f"{name}: {per_call[name]} device kernels a call, not {want}")


def _lp_gates(name, c, A_ub, b_ub, A_eq, b_eq, x, highs_fun, res=None):
    """Objective and feasibility of an LP solution; raises outside the gates."""
    x = x.detach().double().cpu().numpy()
    out = {"objective": float(c @ x), "highs_objective": float(highs_fun),
           "objective_gap": float((c @ x - highs_fun) / abs(highs_fun)),
           "x_min": float(x.min()),
           "eq_gap": float(np.abs(A_eq @ x - b_eq).max()) if A_eq is not None else 0.0,
           "ub_gap": float((A_ub @ x - b_ub).max())}
    if res is not None:
        out.update(iterations=res["iters"], r_norm=res["r_norm"], eps_primal=res["eps_primal"],
                   s_norm=res["s_norm"], eps_dual=res["eps_dual"])
        if not (res["r_norm"] < res["eps_primal"] and res["s_norm"] < res["eps_dual"]):
            raise AssertionError(f"{name}: not converged: {res}")
        limit = res["r_norm"] * (1 + LP_GAP_SLACK) + 1e-6
        if not (out["eq_gap"] <= limit and out["ub_gap"] <= limit and -out["x_min"] <= limit):
            raise AssertionError(f"{name}: feasibility gaps {out['eq_gap']}, {out['ub_gap']}, "
                                 f"x.min() {out['x_min']} above the solve's r_norm {res['r_norm']}")
    if not abs(out["objective_gap"]) <= LP_OBJECTIVE_TOL:
        raise AssertionError(f"{name}: objective gap {out['objective_gap']} > {LP_OBJECTIVE_TOL}")
    return out


def _highs(c, A_ub, b_ub, A_eq, b_eq):
    from scipy.optimize import linprog

    ref = linprog(c, A_ub, b_ub, A_eq, b_eq, bounds=(0, None), method="highs")
    if not ref.success:
        raise AssertionError(f"HiGHS failed: {ref.message}")
    return ref.fun


def phase_lp(kernels, dev, card):
    from dprox_tpu_torch.algo import lp
    from dprox_tpu_torch.algo.lp.solvers import LPConvergenceLoss, pretrain_lp
    from dprox_tpu_torch.contrib.energy_system import synthetic_cep_model
    from dprox_tpu_torch.linalg import solvers

    c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(512, 16)
    data = (c, A_ub, b_ub, A_eq, b_eq)
    t0 = time.perf_counter()
    highs_fun = _highs(*data)
    highs_s = time.perf_counter() - t0
    p = lp.LPProblem(*data, dtype=torch.float32)
    if (p.device.type != "cuda" or not isinstance(p.A, lp.BSRMat) or p.A.route != "csr"
            or p.AT.base is not p.A):
        raise AssertionError(f"LPProblem on {p.device} with operator {type(p.A).__name__} "
                             f"on route {getattr(p.A, 'route', None)}")
    solver = lp.LPSolverADMM(dtype=torch.float32, verbose=False)

    # the main path: one solve with the counts read around it, then the same
    # solve again for the warm time
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    x, res = solver.solve_fused(p, max_iters=20000)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    x2, res2 = solver.solve_fused(p, max_iters=20000)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    out = _lp_gates("lp", *data, x, highs_fun, res)
    iters = res["iters"]
    chunks = -(-iters // 25)
    # per ADMM iteration: A^T once for the right-hand side, A and A^T in the
    # PCG's set-up and in each of its iterations, A once after it; bdot once in
    # the set-up and twice per PCG iteration; A and A^T once per chunk's
    # residual evaluation. Both directions take the compressed route.
    inner, odd = divmod(launches["bdot"] - iters, 2)
    expected = dict.fromkeys(launches, 0) | {
        "bdot": launches["bdot"], "csr_matvec": 4 * iters + 2 * inner + 2 * chunks}

    # one ADMM iteration's stages at the middle of the solve: replay the
    # first half (the solve is deterministic) and keep that iteration's inputs
    class Recording(lp.LPSolverADMM):
        at, calls, snapshot = max(iters // 2, 1), 0, None

        def _one_iter(self, p, carry, *args):
            self.calls += 1
            if self.calls == self.at:
                self.snapshot = (carry, args)
            return super()._one_iter(p, carry, *args)

    rec = Recording(dtype=torch.float32, verbose=False)
    rec.solve_fused(p, max_iters=rec.at)
    carry, (rtol, rho, c_s, sigma, alpha, lb, ub, pcg_iters) = rec.snapshot
    xs, zs, ys, xts = carry
    before = kernels.bdot.launches
    one_iter = lambda: solver._one_iter(p, carry, rtol, rho, c_s, sigma, alpha, lb, ub, pcg_iters)
    with torch.no_grad():
        one_iter()
        inner_here = (kernels.bdot.launches - before - 1) // 2
        M = (sigma + rho * p.Acnorm ** 2)[None]
        r, z, pk, Ap = (torch.randn(1, p.n, device=dev) for _ in range(4))
        rz = solvers.bdot(r, z)
        tol = rtol * solvers._clamp(solvers._bmax(r))

        def pcg_elementwise():  # everything of a PCG iteration but matvecs and dots
            Ap2 = rho * Ap[0] + sigma * pk[0]  # the two scalings inside KtK
            alpha_k = rz / solvers._clamp(rz)
            x_new = r + alpha_k[:, None] * pk
            r_new = r - alpha_k[:, None] * Ap
            z_new = r_new / M
            beta = rz / solvers._clamp(rz)
            return z_new + beta[:, None] * pk, x_new, Ap2

        gam = p.gamma_c * torch.ones((), device=dev), p.gamma_b * torch.ones((), device=dev)
        stages = {
            "iteration_with_host_reads": _best_ms(one_iter),
            "pcg_iterations_in_it": inner_here,
            "matvec_A": time_ms(lambda: p.A @ xs, 20, 5, graph=False),
            "matvec_A_device": time_ms(lambda: p.A @ xs, 20, 5),
            "matvec_AT": time_ms(lambda: p.AT @ zs, 20, 5, graph=False),
            "matvec_AT_device": time_ms(lambda: p.AT @ zs, 20, 5),
            "bdot": time_ms(lambda: solvers.bdot(r, z), 20, 5, graph=False),
            "bdot_device": time_ms(lambda: solvers.bdot(r, z), 20, 5),
            "pcg_elementwise": time_ms(pcg_elementwise, 20, 5, graph=False),
            "pcg_elementwise_device": time_ms(pcg_elementwise, 20, 5),
            "stop_test_host_read": _best_ms(lambda: bool((solvers._bmax(r) > tol).any())),
            "eval_result": time_ms(lambda: solver.eval_result(p, c_s, *gam, xs, zs, ys), 20, 5,
                                   graph=False),
            "eval_result_device": time_ms(lambda: solver.eval_result(p, c_s, *gam, xs, zs, ys),
                                          20, 5),
        }

    # the training path: Adam steps through solve_truncated, i.e. through the
    # kernel's backward and the differentiable bdot
    kernels.reset_launches()
    t0 = time.perf_counter()
    params, log = pretrain_lp(solver, p, steps=10)
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    pretrain_launches = kernels.launch_counts()
    t0 = time.perf_counter()
    x_lp, history, results = lp.solve_lp(*data, verbose=False, dtype=torch.float32)
    torch.cuda.synchronize()
    solve_lp_s = time.perf_counter() - t0
    trained = _lp_gates("solve_lp", *data, x_lp, highs_fun)
    trained.update(iterations=25 * len(history["t_chunk"]), seconds=solve_lp_s,
                   converged=bool(results[1] < results[3] and results[2] < results[4]))

    # d loss / d rho of the truncated solve against a central difference, in
    # float64 on the card (float64 kernels), at synthetic_cep_model(64, 8)
    c8, A_ub8, A_eq8, b_ub8, b_eq8 = synthetic_cep_model(64, 8)
    data8 = (c8, A_ub8, b_ub8, A_eq8, b_eq8)
    p64 = lp.LPProblem(*data8, dtype=torch.float64)
    s64 = lp.LPSolverADMM(dtype=torch.float64, verbose=False)
    loss_fn = LPConvergenceLoss()

    def loss_at(rho_value, grad=False):
        prm = s64.init_params()
        prm["rho"] = torch.tensor(rho_value, dtype=torch.float64, device=dev, requires_grad=grad)
        with torch.set_grad_enabled(grad):
            val = loss_fn(*s64.solve_truncated(p64, prm, iters=10))
        if grad:
            return float(torch.autograd.grad(val, prm["rho"])[0])
        return float(val)

    h = 1e-6
    fd = (loss_at(1.0 + h) - loss_at(1.0 - h)) / (2 * h)
    ad = loss_at(1.0, grad=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    x64, res64 = s64.solve_fused(p64, max_iters=20000)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    f64_launches = kernels.launch_counts()
    f64 = _lp_gates("lp float64", *data8, x64, _highs(*data8), res64)
    f64.update(seconds=f64_s, launches=f64_launches)

    # the chunked solve at the 2048-period instance: seconds per iteration only
    cb, A_ubb, A_eqb, b_ubb, b_eqb = synthetic_cep_model(2048, 16)
    pb = lp.LPProblem(cb, A_ubb, b_ubb, A_eqb, b_eqb, dtype=torch.float32)
    solver.solve(pb, max_iters=25)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xb, hist_b, res_b = solver.solve(pb, max_iters=200)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    big_launches = kernels.launch_counts()
    big = {"shape": list(pb.A.shape), "tiles": pb.A.n_tiles, "iterations": 200, "seconds": big_s,
           "s_per_iteration": big_s / 200,
           "pcg_iterations": (big_launches["bdot"] - 200) // 2,
           "route": pb.A.route, "csr_matvec_launches": big_launches["csr_matvec"],
           "bdot_launches": big_launches["bdot"],
           "bsr_matvec_launches": big_launches["bsr_matvec"],
           "finite": bool(torch.isfinite(xb).all())}

    emit({"phase": "lp", "config": "synthetic_cep_model(512, 16), float32, "
          "LPSolverADMM().solve_fused(p, max_iters=20000)",
          "A_shape": list(p.A.shape), "nnz": int(p.A.nnz), "tiles": p.A.n_tiles,
          "route": p.A.route,
          **out, "jax_cpu_iterations": JAX_CPU_LP_ITERS,
          "jax_cpu": {"objective": JAX_CPU_LP_OBJECTIVE, "x_min": JAX_CPU_LP_X_MIN,
                      "eq_gap": JAX_CPU_LP_EQ_GAP, "ub_gap": JAX_CPU_LP_UB_GAP},
          "gaps_within_2x_jax_cpu": {"eq_gap": out["eq_gap"] <= 2 * JAX_CPU_LP_EQ_GAP,
                                     "ub_gap": out["ub_gap"] <= 2 * JAX_CPU_LP_UB_GAP},
          "highs_s": highs_s, "first_solve_s": first_s, "warm_s": warm_s,
          "second_solve_equals_first": bool(torch.equal(x, x2)) and res2["iters"] == iters,
          "s_per_iteration": warm_s / iters, "pcg_iterations": inner,
          "pcg_iterations_per_iteration": inner / iters, "launches": launches,
          "stage_at_iteration": rec.at, "stage_ms": stages,
          "pretrain": {"steps": len(log), "seconds": pretrain_s, "losses": [e["loss"] for e in log],
                       "first_step_gradients": log[0]["grad"], "launches": pretrain_launches,
                       "best": {k: float(v) for k, v in params.items()}},
          "solve_lp": trained,
          "dloss_drho_float64": {"autograd": ad, "central_difference": fd, "h": h,
                                 "instance": "synthetic_cep_model(64, 8)"},
          "float64_solve": {"config": "synthetic_cep_model(64, 8), solve_fused", **f64},
          "chunked_2048": big, "card": card})
    if launches != expected or odd or inner <= 0:
        raise AssertionError(f"lp: launch counts {launches} != {expected} "
                             f"(iterations {iters}, PCG iterations {inner}, chunks {chunks})")
    if tuple(x.shape) != (p.n,) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"lp: bad output shape {tuple(x.shape)} or non-finite values")
    if not out["x_min"] >= LP_X_MIN:
        raise AssertionError(f"lp: x.min() {out['x_min']} < {LP_X_MIN}")
    if not all(np.isfinite(e["loss"]) for e in log):
        raise AssertionError(f"lp pretraining: non-finite loss in {[e['loss'] for e in log]}")
    if not all(np.isfinite(g) and g != 0.0 for g in log[0]["grad"].values()):
        raise AssertionError(f"lp pretraining: zero or non-finite gradient {log[0]['grad']}")
    if pretrain_launches["csr_matvec"] <= 0 or pretrain_launches["bdot"] <= 0:
        raise AssertionError(f"lp pretraining launched no kernel: {pretrain_launches}")
    if not abs(ad - fd) <= 1e-4 * abs(fd):
        raise AssertionError(f"d loss / d rho: autograd {ad} vs central difference {fd}")
    if not big["finite"] or big["route"] != "csr" or big["bsr_matvec_launches"]:
        raise AssertionError(f"chunked solve at 2048 periods: non-finite values or "
                             f"route {big['route']}")
    return launches


def phase_lp_consensus(kernels, dev, card):
    from scipy.optimize import linprog

    from dprox_tpu_torch.algo.lp import solve_consensus_lp
    from dprox_tpu_torch.contrib.energy_system import extensive_form, synthetic_cep_scenarios

    inst = synthetic_cep_scenarios(64, 8, 8)
    c, A_ub, A_eq, b_ub, b_eq_s, sh = inst
    cf, Auf, Aef, buf, bef = extensive_form(*inst)
    ref = linprog(cf, Auf, buf, Aef, bef, bounds=(0, None), method="highs")
    if not ref.success:
        raise AssertionError(f"HiGHS failed on the extensive form: {ref.message}")
    kw = dict(max_outer=300, eval_freq=50, tol=1e-3, rho_ph=1.0, verbose=False, fused=True,
              dtype=torch.float32)
    # the same solve twice: the first warms up, the second is timed, and the
    # two must agree bit for bit (the scenario applies sum in a fixed order)
    z1, xs1, _, res1 = solve_consensus_lp(c, A_ub, b_ub, A_eq, b_eq_s, sh, **kw)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    z, xs, _, res = solve_consensus_lp(c, A_ub, b_ub, A_eq, b_eq_s, sh, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    same = (np.array_equal(z, z1) and np.array_equal(xs, xs1)
            and res["objective"] == res1["objective"])
    gap = (res["objective"] - ref.fun) / abs(ref.fun)
    emit({"phase": "lp_consensus", "config": "synthetic_cep_scenarios(64, 8, 8), float32, "
          "solve_consensus_lp(max_outer=300, eval_freq=50, tol=1e-3, rho_ph=1.0, fused=True)",
          "objective": res["objective"], "highs_extensive_form_objective": float(ref.fun),
          "objective_gap": gap, "outer_iterations": res["outer_iters"],
          "r_nonanticipativity": res["r_nonanticipativity"], "r_primal": res["r_primal"],
          "rho_ph_final": res["rho_ph_final"], "warm_s": seconds,
          "second_solve_equals_first": same,
          "s_per_outer_iteration": seconds / res["outer_iters"], "launches": launches,
          "pcg_iterations": (launches["bdot"] - 10 * res["outer_iters"]) // 2,
          "kernels_on_this_path": "bdot only: the scenario-batched applies A @ X are "
                                  "torch.bmm over the tiles and a segment sum in tile order, "
                                  "as the JAX package leaves them to dot_general and "
                                  "segment_sum outside any Pallas kernel",
          "card": card})
    expected = dict.fromkeys(launches, 0) | {"bdot": launches["bdot"]}
    if launches != expected or launches["bdot"] <= 0:
        raise AssertionError(f"lp_consensus: launch counts {launches} != {expected}")
    if xs.shape != (8, c.shape[0]) or not (np.isfinite(xs).all() and np.isfinite(z).all()):
        raise AssertionError("lp_consensus: bad output shape or non-finite values")
    if not abs(gap) <= CONSENSUS_OBJECTIVE_TOL:
        raise AssertionError(f"lp_consensus: objective gap {gap} > {CONSENSUS_OBJECTIVE_TOL}")
    if not same:
        raise AssertionError("lp_consensus: two solves of one problem differ")


def luminance_observation(psf, dev):
    """(img, b) as 1x1x512x512 tensors on ``dev``: the luminance of the
    synthetic face, blurred with ``psf`` in float64 on the host and rounded
    to float32, as scripts/smoke_references.py makes them."""
    from dprox_tpu_torch.utils.fft import psf2otf
    from dprox_tpu_torch.utils.imaging import _synthetic_face

    img = np.tensordot(LUMA, _synthetic_face(512, 512).transpose(2, 0, 1).astype(np.float64),
                       axes=1)[None, None]
    otf = psf2otf(np.asarray(psf).squeeze(), img.shape[-2:])
    b = np.real(np.fft.ifft2(otf * np.fft.fft2(img))).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in (img, b))


def _iteration_ms(solver, b, rho, lam, params=None):
    """One iteration of ``solver`` from its initial state: eager (host
    launch overhead included, as in the solve loop) and device time from a
    CUDA-graph replay. ``params``: the solve's placeholder values, on the
    device."""
    params = params or {}
    aux = solver.prepare_aux(b, params)
    state = solver.initialize(b, params)
    rho = torch.as_tensor(rho, dtype=torch.float32, device=b.device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=b.device)
    p_it = dict(params, __step__=0)
    step = lambda: solver._iter(state, rho, [lam] * len(solver.psi_fns), 0, p_it, aux)  # noqa: E731
    return {"iteration_eager_ms": time_ms(step, 10, 3, graph=False),
            "iteration_device_ms": time_ms(step, 10, 3)}


def _gated_solve(kernels, solver, img, b, max_iter, rhos, lams, ref, tol, expected,
                 **solve_kw):
    """Solve once with the launch counts read around it; returns the
    record. Fails on a bad shape, non-finite values, a PSNR more than
    ``tol`` dB from the JAX-CPU ``ref`` or launch counts other than
    ``expected`` (the kernels not named there: 0). ``solve_kw`` goes to
    the solve (params, real_output)."""
    from dprox_tpu_torch.utils.metrics import psnr

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = solver.solve(x0=b, max_iter=max_iter, rhos=rhos, lams=lams, **solve_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    p_x = psnr(out, img)
    rec = {"iterations": max_iter, "solve_s": seconds, "launches": launches, "psnr_x": p_x,
           "jax_cpu_psnr_x": ref, "psnr_gap_db": p_x - ref, "psnr_gap_limit_db": tol,
           "launches_per_iteration": {k: v / max_iter for k, v in launches.items() if v}}
    if out.shape != img.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad output: shape {tuple(out.shape)} or non-finite values")
    if not abs(p_x - ref) <= tol:
        raise AssertionError(f"PSNR {p_x} not within {tol} dB of JAX-CPU {ref}")
    want = dict.fromkeys(launches, 0) | expected
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    return rec


class _PlainTV:
    """A TV denoiser with the kernel's plain version in place of the kernel."""

    def __init__(self, iter_num):
        self.iter_num = iter_num

    def denoise(self, x, sigma):
        from dprox_tpu_torch.ops.kernels import tv_denoise_chw_plain

        B, C, H, W = x.shape
        lam = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1)
        return tv_denoise_chw_plain(x.reshape(B * C, H, W), lam, self.iter_num).reshape(
            B, C, H, W)


def phase_family(dp, kernels, dev, card, flagship_its):
    """The FFDNet prior family at 512x512: the flagship under x8, in
    bfloat16, the res_ffdnet_color_tv fusion and the gray distilled_gray_tv
    on the face's luminance, each against the JAX package on the CPU; and
    one x8 denoise of a 3x384x512 input against the same call with the
    plain TV."""
    import copy

    from dprox_tpu_torch.proxfn.pnp import Augment, get_denoiser
    from dprox_tpu_torch.utils.imaging import point_spread_function

    psf = point_spread_function(15, 5)
    img, b = observation(512, psf, False, dev)
    gimg, gb = luminance_observation(psf, dev)
    r24, s24 = dp.log_descent(80, 25, 24)
    r48, s48 = dp.log_descent(80, 30, 48)
    # (name, prior, x8, observation, iterations, schedules, marginal span,
    #  TV launches per iteration)
    cases = [("distilled_color_tv_x8", "distilled_color_tv", True, (img, b), 24, (r24, s24),
              (4, 24), 8),
             ("distilled_color_tv_bf16", "distilled_color_tv_bf16", False, (img, b), 48,
              (r48, s48), (8, 48), 1),
             ("res_ffdnet_color_tv", "res_ffdnet_color_tv", False, (img, b), 48, (r48, s48),
              (8, 48), 1),
             ("distilled_gray_tv", "distilled_gray_tv", False, (gimg, gb), 48, (r48, s48),
              (8, 48), 1)]
    solves, by_path = {}, {}
    for name, prior, x8, (im, ob), n, (rhos, sigmas), (lo, hi), tv_per_it in cases:
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - ob),
                             dp.deep_prior(x, prior, x8=x8)], "admm")
        tol = PSNR_TOL_BF16_DB if name.endswith("bf16") else PSNR_TOL_DB
        rec = _gated_solve(kernels, solver, im, ob, n, rhos, sigmas, JAX_CPU_FAMILY_PSNR_X[name],
                           tol, {"tv_denoise_chw": tv_per_it * n, "freq_divide": n})
        by_path[f"family_{name}"] = rec["launches"]
        obs = _marginal(lambda k: solver.solve(x0=ob, max_iter=k, rhos=rhos[:k],
                                               lams=sigmas[:k]), lo, hi, reps=3, estimates=3)
        rec.update(its_per_sec=statistics.median(obs), obs=obs, span=f"{lo}-{hi}",
                   statistic="median of 3 best-of-3",
                   **_iteration_ms(solver, ob, rhos[0], sigmas[0]))
        if name.endswith("bf16"):
            rec["float32_stand_in_gap_db"] = (JAX_CPU_FLOAT32_AT_BF16_SETTINGS
                                              - JAX_CPU_FAMILY_PSNR_X[name])
            rec["float32_flagship_its_per_sec"] = flagship_its
            rec["its_per_sec_over_float32_flagship"] = rec["its_per_sec"] / flagship_its
        solves[name] = rec
        del solver

    # x8 on a non-square input: the TV kernel gets 384x512 and 512x384
    # planes; cuDNN picks deterministic algorithms for both calls
    rng = np.random.RandomState(10)
    y = torch.from_numpy(rng.rand(1, 3, 384, 512).astype(np.float32)).to(dev)
    sigma = torch.tensor([0.05], device=dev)
    den = get_denoiser("distilled_color_tv").to(dev)
    plain = copy.copy(den)
    plain.tv = _PlainTV(den.tv.iter_num)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            kernels.reset_launches()
            got = Augment(den).denoise(y, sigma)
            tv_launches = kernels.launch_counts()["tv_denoise_chw"]
            ref = Augment(plain).denoise(y, sigma)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    x8_check = {"shape": [1, 3, 384, 512], "tv_launches": tv_launches,
                "bit_equal_to_plain_tv": torch.equal(got, ref),
                "max_abs_err": float((got - ref).abs().max())}
    emit({"phase": "family", "config": "deep_prior(x, kind) deconvolution, psf(15, 5), "
          "1x3x512x512 synthetic face (gray: its 1x1x512x512 luminance)", "solves": solves,
          "x8_non_square_denoise": x8_check, "card": card})
    if not (x8_check["bit_equal_to_plain_tv"] and tv_launches == 8):
        raise AssertionError(f"x8 denoise on 3x384x512: {x8_check}")
    return by_path


def phase_algos(dp, kernels, dev, card):
    """Every solver on the 512x512x3 deconvolution with nonneg (the
    settings of tests/test_algorithms.py, 24 iterations), hqs and admm_vxu
    with the flagship prior (48 iterations), the same nonneg problem
    through dp.Problem, and the LP dispatch Problem(c @ x, [A @ x == b])
    against HiGHS."""
    from scipy.optimize import linprog

    from dprox_tpu_torch.utils.imaging import point_spread_function

    psf = point_spread_function(15, 5)
    img, b = observation(512, psf, False, dev)
    solves, by_path = {}, {}
    for method in ("admm", "ladmm", "admm_vxu", "hqs", "pc", "pgd", "cadmm"):
        kw = {"pc": dict(rhos=1.0, lams=0.1), "pgd": dict(rhos=0.4, lams=0.002)}.get(
            method, dict(rhos=0.05, lams=0.01))
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b), dp.nonneg(x)], method)
        expected = {"freq_divide": 0 if method == "pgd" else 24,
                    "fused_admm_update": 24 if method == "admm" else 0}
        name = f"{method}_nonneg"
        rec = _gated_solve(kernels, solver, img, b, 24, kw["rhos"], kw["lams"],
                           JAX_CPU_ALGOS_PSNR_X[name], PSNR_TOL_DB, expected)
        rec.update(settings=kw, **_iteration_ms(solver, b, kw["rhos"], kw["lams"]))
        solves[name] = rec
        by_path[f"algos_{name}"] = rec["launches"]
    rhos, sigmas = dp.log_descent(80, 30, 48)
    for method in ("hqs", "admm_vxu"):
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b),
                             dp.deep_prior(x, "distilled_color_tv")], method)
        name = f"{method}_distilled_color_tv"
        rec = _gated_solve(kernels, solver, img, b, 48, rhos, sigmas, JAX_CPU_ALGOS_PSNR_X[name],
                           PSNR_TOL_DB, {"tv_denoise_chw": 48, "freq_divide": 48})
        rec.update(**_iteration_ms(solver, b, rhos[0], sigmas[0]))
        solves[name] = rec
        by_path[f"algos_{name}"] = rec["launches"]
        del solver

    from dprox_tpu_torch.utils.metrics import psnr

    x = dp.Variable()
    prob = dp.Problem(dp.sum_squares(dp.conv(x, psf) - b) + dp.nonneg(x))
    kernels.reset_launches()
    out = prob.solve(x0=b, max_iter=24, rhos=0.05, lams=0.01)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    p_x = psnr(out, img)
    ref = JAX_CPU_ALGOS_PSNR_X["problem_nonneg"]
    problem = {"launches": launches, "psnr_x": p_x, "jax_cpu_psnr_x": ref,
               "psnr_gap_db": p_x - ref, "output_device": str(out.device)}

    # the LP dispatch of tests/test_lp.py::test_problem_dispatches_lp
    rng = np.random.RandomState(1)
    n = 10
    c = rng.rand(n) + 0.1
    A = rng.rand(4, n)
    rhs = A @ rng.rand(n)
    xv = dp.Variable()
    kernels.reset_launches()
    sol, _, res = dp.Problem(c @ xv, [A @ xv == rhs]).solve(max_iters=3000, pretrain_steps=3,
                                                             verbose=False)
    objval, r_norm, s_norm, eps_p, eps_d = (float(v) for v in res)
    torch.cuda.synchronize()
    lp_launches = kernels.launch_counts()
    sol = sol.detach().cpu().double().numpy()
    highs = linprog(c, A_eq=A, b_eq=rhs, bounds=[(0, None)] * n, method="highs")
    lp = {"launches": lp_launches, "r_norm": r_norm, "eps_primal": eps_p, "s_norm": s_norm,
          "eps_dual": eps_d,
          "max_constraint_residual": float(np.abs(A @ sol - rhs).max()),
          "objective": float(c @ sol), "highs_objective": float(highs.fun),
          "objective_rel_gap": float(abs(c @ sol - highs.fun) / abs(highs.fun))}
    emit({"phase": "algos", "config": "sum_squares(conv(x, psf(15, 5)) - b) + nonneg(x) or "
          "deep_prior(x, 'distilled_color_tv'), 1x3x512x512", "solves": solves,
          "problem": problem, "lp_dispatch": lp, "card": card})
    by_path["algos_problem_nonneg"] = launches
    by_path["algos_lp_dispatch"] = lp_launches
    if not abs(p_x - ref) <= PSNR_TOL_DB:
        raise AssertionError(f"Problem: PSNR {p_x} not within {PSNR_TOL_DB} dB of {ref}")
    if launches != dict.fromkeys(launches, 0) | {"freq_divide": 24, "fused_admm_update": 24}:
        raise AssertionError(f"Problem: launch counts {launches}")
    if not (lp["max_constraint_residual"] < 5e-2 and lp["objective_rel_gap"] <= 1e-2
            and lp_launches["csr_matvec"] > 0 and lp_launches["bdot"] > 0):
        raise AssertionError(f"LP dispatch: {lp}")
    return by_path


def phase_check_complex(kernels, dev):
    """freq_divide's complex-divisor entry against its plain version at the
    main path's shape and odd sizes (a sliced divisor read by strides), and
    the TV kernel on a complex tensor's real part made contiguous, bit for
    bit; returns the complex entry's measurements."""
    rng = np.random.RandomState(8)
    cases = []
    for fshape, per_batch, sliced in [((1, 3, 512, 512), False, False),
                                      ((2, 3, 37, 53), True, False),
                                      ((1, 3, 64, 33), False, True)]:
        F = torch.from_numpy((rng.randn(*fshape) + 1j * rng.randn(*fshape))
                             .astype(np.complex64)).to(dev)
        dshape = fshape[:-1] + (2 * fshape[-1] - 2,) if sliced else (1,) + fshape[1:]
        diag = torch.from_numpy((0.5 + rng.rand(*dshape) + 1j * rng.randn(*dshape))
                                .astype(np.complex64)).to(dev)[..., :fshape[-1]]
        B = fshape[0]
        rho = torch.from_numpy((1e-2 * (1 + rng.rand(B if per_batch else 1)))
                               .astype(np.float32)).to(dev)
        rho = rho.reshape(-1, 1, 1, 1) if per_batch else rho.reshape(())
        before = kernels.freq_divide.complex_launches
        got = kernels.freq_divide(F, diag, rho)
        ref = kernels.freq_divide_plain(F, diag, rho)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        cases.append({"shape": list(fshape), "rho_per_batch": per_batch,
                      "diag_strides": diag.stride(), "max_abs_err": err, "max_rel_err": rel,
                      "bit_equal": torch.equal(got, ref),
                      "complex_launches": kernels.freq_divide.complex_launches - before})
        if not (rel <= DIVIDE_REL_TOL and cases[-1]["complex_launches"] == 1):
            raise AssertionError(f"freq_divide, complex divisor {fshape}: {cases[-1]}")
        if fshape == (1, 3, 512, 512):
            main = (F, diag, rho, err)

    # the TV kernel on the real part of a complex 1x128x128 state, as
    # deep_prior hands it over (the strided view itself is refused)
    z = torch.from_numpy((rng.rand(1, 128, 128) + 1j * rng.rand(1, 128, 128))
                         .astype(np.complex64)).to(dev)
    lam = torch.full((1,), 0.05, device=dev)
    try:
        kernels.tv_denoise_chw(z.real, lam, 10)
        refused = False
    except ValueError:
        refused = True
    y = z.real.contiguous()
    tv_equal = torch.equal(kernels.tv_denoise_chw(y, lam, 10),
                           kernels.tv_denoise_chw_plain(y, lam, 10))

    F, diag, rho, err = main
    n = F.numel()
    # each input read once (F and diag 8 bytes an element), out written
    # once; a complex divide takes ~11 float operations an element
    b = bound(8 * n + 8 * diag.numel() + 4 * rho.numel() + 8 * n, 11 * n)
    row = {"name": "freq_divide_complex", "route": "cuda",
           "source": "dprox_tpu_torch/csrc/freq_divide.cu (dprox_freq_divide_c64)",
           "replaces": "dprox_tpu/ops/pallas_kernels.py:104",
           "max_abs_err": err, "ms": time_ms(lambda: kernels.freq_divide(F, diag, rho)),
           "plain_ms": time_ms(lambda: kernels.freq_divide_plain(F, diag, rho)),
           "bound_ms": b[0], "bound_by": b[1],
           "library_ms": time_ms(lambda: (F + 1e-7) / (diag + rho + 1e-7))}
    emit({"phase": "check_complex", "divide_cases": cases, "timing_shape": [1, 3, 512, 512],
          "eager_ms": time_ms(lambda: kernels.freq_divide(F, diag, rho), graph=False),
          "measured": row, "tv_on_complex_real_part": {
              "shape": [1, 128, 128], "strided_view_refused": refused,
              "contiguous_copy_bit_equal_to_plain": tv_equal}})
    if not (refused and tv_equal):
        raise AssertionError(f"TV on a complex state's real part: refused {refused}, "
                             f"bit-equal {tv_equal}")
    return [row]


def _keys_weights(n_in, n_out):
    """[n_in, n_out] float64 weights of jax.image.resize(method="cubic")
    when it upsamples: Keys' kernel (a = -0.5), columns summing to 1."""
    sample = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    w = np.where(x >= 2, 0.0, np.where(x >= 1, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                                       ((1.5 * x - 2.5) * x) * x + 1.0))
    return w / w.sum(0, keepdims=True)


def sr_observation(img, psf, sf):
    """(y, x0) float32 numpy: ``img`` [1,C,H,W] blurred circularly by
    ``psf`` in float64, every ``sf``-th pixel, and its cubic upsampling,
    as scripts/smoke_references.py makes them for the JAX package."""
    from dprox_tpu_torch.utils.fft import psf2otf

    otf = psf2otf(np.asarray(psf).squeeze(), img.shape[-2:])
    y = np.real(np.fft.ifft2(otf * np.fft.fft2(img.astype(np.float64))))[..., ::sf, ::sf]
    h, w = y.shape[-2:]
    x0 = np.einsum("bchw,hH,wW->bcHW", y, _keys_weights(h, h * sf), _keys_weights(w, w * sf))
    return y.astype(np.float32), x0.astype(np.float32)


def synthetic_hsi(bands=8, size=64):
    """examples/papers/hsi_suite.py's cube on the synthetic face: [1,8,64,64]
    bands mixed from its RGB crop, and the [8, 3] spectral response."""
    from dprox_tpu_torch.utils.imaging import _synthetic_face

    rgb = _synthetic_face(512, 512).transpose(2, 0, 1)[:, :size, :size]
    ws = np.stack([np.abs([np.cos(0.2 * b), np.sin(0.15 * b) ** 2, 0.5 + 0.5 * np.cos(0.3 * b)])
                   for b in range(bands)])
    ws = ws / ws.sum(1, keepdims=True)
    return np.einsum("bc,chw->bhw", ws, rgb)[None].astype(np.float32), ws


def _noisy(a, sigma=0.05):
    """tests/paper/test_hsi_grid.py's measurement noise."""
    a = np.asarray(a)
    return (a + sigma * np.random.RandomState(5).randn(*a.shape)).astype(np.float32)


def phase_fast(dp, kernels, dev, card):
    """The fused fast proxes and complex solver states: CS-MRI on the 128x128
    phantom (complex k-space state; TV on its real part), SISR at full
    width through dp.Problem, the HSI fast proxes with 3-D TV, and the
    flagship with conv_doe."""
    from dprox_tpu_torch.contrib import csmri
    from dprox_tpu_torch.proxfn.pnp.denoisers import TVDenoiser
    from dprox_tpu_torch.utils.imaging import _synthetic_face, point_spread_function
    from dprox_tpu_torch.utils.metrics import mpsnr, psnr

    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    solves, by_path = {}, {}

    def csmri_solver(prior):
        x = dp.Variable()
        return dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                          + dp.deep_prior(x, prior, sqrt=True), "admm")

    def schedule(sigma, n):  # tests/paper/test_csmri_grid.py's noise-adaptive one
        return dp.log_descent(30 + 600 * sigma, 5 + 300 * sigma, n, sigma=0.01)

    # CS-MRI: the grid's cells with both priors; each its TV launches only
    for lines, sigma in CSMRI_CELLS:
        s = csmri.generate_sample(size=128, num_lines=lines, sigma=sigma)
        gt = on_dev(s["gt"])
        for prior in ("distilled_gray_tv", "tv"):
            name = f"csmri_{prior}_{lines}_{sigma}"
            rhos, sigmas = schedule(sigma, 24)
            rec = _gated_solve(kernels, csmri_solver(prior), gt, s["x0"], 24, rhos, sigmas,
                               JAX_CPU_FAST_PSNR_X[name], PSNR_TOL_DB, {"tv_denoise_chw": 24},
                               params=s["params"], real_output=True)
            rec["psnr_zero_filled"] = psnr(np.real(s["x0"]), s["gt"])
            solves[name] = rec
            by_path[name] = rec["launches"]
    # marginal its/s and one iteration at (40, 0) with distilled_gray_tv
    s = csmri.generate_sample(size=128, num_lines=40)
    solver = csmri_solver("distilled_gray_tv")
    rhos, sigmas = schedule(0.0, 48)
    obs = _marginal(lambda k: solver.solve(x0=s["x0"], max_iter=k, rhos=rhos[:k],
                                           lams=sigmas[:k], params=s["params"]),
                    8, 48, reps=3, estimates=3)
    params = {k: on_dev(v) for k, v in s["params"].items()}
    rec = solves["csmri_distilled_gray_tv_40_0.0"]
    rec.update(its_per_sec=statistics.median(obs), obs=obs, span="8-48",
               statistic="median of 3 best-of-3",
               **_iteration_ms(solver, solver._prepare_x0(s["x0"]), rhos[0], sigmas[0], params))
    # contrib.csmri.CustomADMM (prox-first) on cell (40, 0), complex output
    x = dp.Variable()
    psi, omega = csmri.CustomADMM.partition(
        [dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y")),
         dp.deep_prior(x, "tv")])
    kernels.reset_launches()
    out = csmri.CustomADMM(psi, omega).solve(x0=s["x0"], max_iter=8, rhos=0.2, lams=0.05,
                                             params=s["params"])
    torch.cuda.synchronize()
    p_x, ref = psnr(out.real, s["gt"]), JAX_CPU_FAST_PSNR_X["csmri_custom_admm_40_0.0"]
    solves["csmri_custom_admm_40_0.0"] = {
        "iterations": 8, "output_dtype": str(out.dtype), "launches": kernels.launch_counts(),
        "psnr_x": p_x, "jax_cpu_psnr_x": ref, "psnr_gap_db": p_x - ref}
    by_path["csmri_custom_admm"] = kernels.launch_counts()
    if not (abs(p_x - ref) <= PSNR_TOL_DB and out.dtype == torch.complex64):
        raise AssertionError(f"CustomADMM: {solves['csmri_custom_admm_40_0.0']}")

    # SISR at full width: dp.Problem over sisr with res_ffdnet_color_tv
    img = _synthetic_face(512, 512).transpose(2, 0, 1)[None]
    psf = point_spread_function(15, 2)
    y, x0 = sr_observation(img, psf, 2)
    kernel = np.transpose(psf, (2, 0, 1))[None]
    x = dp.Variable()
    prob = dp.Problem(dp.sisr(x, dp.utils.array(y), dp.utils.array(kernel), 2)
                      + dp.deep_prior(x, "res_ffdnet_color_tv"))
    rhos, sigmas = dp.log_descent(60, 20, 24)
    img_d, x0_d = on_dev(img), on_dev(x0)
    rec = _gated_solve(kernels, prob, img_d, x0_d, 24, rhos, sigmas,
                       JAX_CPU_FAST_PSNR_X["sisr_res_ffdnet_color_tv"], PSNR_TOL_DB,
                       {"tv_denoise_chw": 24})
    rec["psnr_x0"] = psnr(x0, img)
    solver = dp.compile(prob.objective, "admm")
    r48, s48 = dp.log_descent(60, 20, 48)
    obs = _marginal(lambda k: solver.solve(x0=x0_d, max_iter=k, rhos=r48[:k], lams=s48[:k]),
                    8, 48, reps=3, estimates=3)
    rho, lam = r48[0].to(dev), s48[0].to(dev)
    denoiser = solver.psi_fns[0].denoiser
    sigma = lam.reshape(-1)
    rec.update(its_per_sec=statistics.median(obs), obs=obs, span="8-48",
               statistic="median of 3 best-of-3", **_iteration_ms(solver, x0_d, rho, lam),
               stage_ms={
                   "ffdnet": time_ms(lambda: denoiser.deep.denoise(x0_d, sigma), 10, 3,
                                     graph=False),
                   "tv_branch": time_ms(lambda: denoiser.tv.denoise(x0_d, sigma), 20, 5,
                                        graph=False),
                   "x_update": time_ms(lambda: solver.least_square.solve([x0_d], rho), 20, 5,
                                       graph=False),
                   "x_update_device": time_ms(lambda: solver.least_square.solve([x0_d], rho),
                                              20, 5)})
    solves["sisr_res_ffdnet_color_tv"] = rec
    by_path["sisr"] = rec["launches"]
    del solver, prob

    # the HSI fast proxes with 3-D TV (no kernel: plain in both packages)
    gt, srf = synthetic_hsi()
    B = gt.shape[1]
    hwc = lambda a: np.transpose(np.asarray(a)[0], (1, 2, 0))  # noqa: E731
    for name in ("sisr", "misr", "cs"):
        x = dp.Variable()
        if name == "sisr":
            psf7 = point_spread_function(7, 2)
            hy, hx0 = sr_observation(gt, psf7, 2)
            data = dp.sisr(x, dp.utils.array(_noisy(hy)),
                           dp.utils.array(np.transpose(psf7, (2, 0, 1))[None]), 2)
            hx0 = _noisy(hx0)
        elif name == "misr":
            hb = _noisy(np.einsum("ck,nkp->ncp", srf.T, gt.reshape(1, B, -1)).reshape(1, 3, 64, 64))
            data = dp.misr(x, dp.utils.array(hb), srf)
            hx0 = np.repeat(hb.mean(1, keepdims=True), B, axis=1)
        else:
            mask = (np.random.RandomState(0).rand(1, B, 64, 64) > 0.5).astype(np.float32)
            hy = _noisy(np.sum(gt * mask, axis=1, keepdims=True))
            data = dp.compress_sensing(x, dp.utils.array(mask), dp.utils.array(hy))
            hx0 = np.repeat(hy / (B // 2), B, axis=1)
        solver = dp.compile([data, dp.deep_prior(x, TVDenoiser(iter_num=10, use_3dtv=True),
                                                 sqrt=True)], "admm")
        rhos, sigmas = dp.log_descent(35 + 300 * 0.05, 10 + 200 * 0.05, 24, sigma=0.05)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = solver.solve(x0=on_dev(hx0), rhos=rhos, lams=sigmas, max_iter=24)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, ref = mpsnr(hwc(out.cpu()), hwc(gt)), JAX_CPU_FAST_PSNR_X[f"hsi_{name}"]
        rec = {"iterations": 24, "solve_s": seconds, "launches": kernels.launch_counts(),
               "mpsnr_x": got, "jax_cpu_mpsnr_x": ref, "mpsnr_gap_db": got - ref,
               "golden_db": HSI_GOLDEN_MPSNR[name]}
        solves[f"hsi_{name}"] = rec
        by_path[f"hsi_{name}"] = rec["launches"]
        if not (abs(got - ref) <= PSNR_TOL_DB and not any(rec["launches"].values())):
            raise AssertionError(f"HSI {name}: {rec}")

    # the flagship with conv_doe in place of conv: the same OTF made on the
    # card from the PSF (psf2otf_traced) against the host's float64 one
    psf5 = point_spread_function(15, 5)
    fimg, fb = observation(512, psf5, False, dev)
    rhos, sigmas = dp.log_descent(80, 30, MAIN_ITERS)
    flag = {}
    for op in ("conv", "conv_doe"):
        x = dp.Variable()
        K = dp.conv(x, psf5) if op == "conv" else dp.conv_doe(x, psf5[..., 0], circular=True)
        solver = dp.compile([dp.sum_squares(K - fb), dp.deep_prior(x, "distilled_color_tv")],
                            "admm")
        kernels.reset_launches()
        out = solver.solve(x0=fb, max_iter=MAIN_ITERS, rhos=rhos, lams=sigmas)
        torch.cuda.synchronize()
        flag[op] = {"psnr_x": psnr(out, fimg), "launches": kernels.launch_counts()}
        by_path[f"flagship_{op}"] = flag[op]["launches"]
        del solver
    flag["psnr_gap_db"] = flag["conv_doe"]["psnr_x"] - flag["conv"]["psnr_x"]
    solves["flagship_conv_doe"] = flag
    want = dict.fromkeys(flag["conv"]["launches"], 0) | {"tv_denoise_chw": MAIN_ITERS,
                                                        "freq_divide": MAIN_ITERS}
    emit({"phase": "fast", "config": "CS-MRI 1x1x128x128 phantoms (24 it.), SISR 1x3x512x512 "
          "res_ffdnet_color_tv (24 it.), HSI 1x8x64x64 tv3d (24 it.), flagship with conv_doe "
          "(48 it.)", "solves": solves, "card": card})
    if not (abs(flag["psnr_gap_db"]) <= CONV_DOE_GAP_DB and flag["conv"]["launches"] == want
            and flag["conv_doe"]["launches"] == want):
        raise AssertionError(f"conv_doe flagship: {flag}")
    return by_path


def deq_observation(sig, sn, seed, dev, k=15, size=128):
    """(gt, y, psf [1, 3, k, k]) float32 tensors on ``dev``: the face
    cropped to ``size``, blurred circularly by point_spread_function(k, sig)
    in float64 on the host, plus sn * RandomState(seed) noise, as
    scripts/smoke_references.py::deq_observation makes them."""
    from dprox_tpu_torch.utils.fft import psf2otf
    from dprox_tpu_torch.utils.imaging import _synthetic_face, point_spread_function

    gt = _synthetic_face(512, 512)[:size, :size].transpose(2, 0, 1)[None]
    psf = point_spread_function(k, sig)
    otf = psf2otf(np.asarray(psf).squeeze(), (size, size))
    y = np.real(np.fft.ifft2(otf * np.fft.fft2(gt.astype(np.float64))))
    y = y + sn * np.random.RandomState(seed).randn(*y.shape)
    psf13 = np.tile(np.transpose(psf, (2, 0, 1))[None], (1, 3, 1, 1))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (gt, y, psf13))


def _special_models(dp, dev):
    """Builders of the shipped trained solvers on ``dev``, by name."""
    from dprox_tpu_torch.algo.base import params_to
    from dprox_tpu_torch.proxfn.pnp.prior import get_denoiser
    from dprox_tpu_torch.utils.checkpoint import deq_params_from_flax, load_flax_msgpack

    def weights(name):
        return os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights", name)

    def color_deq(f_thres=24, anneal=1):  # scripts/train_deq_deconv.py::build_deq
        x = dp.Variable()
        data = dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf"), circular=True),
                              b=dp.Placeholder("y"))
        solver = dp.compile(data + dp.deep_prior(x, get_denoiser("distilled_color"),
                                                 param_key="deq_prior"), "admm", device=dev)
        deq = dp.specialize(solver, "deq", learned_params=True, f_thres=f_thres, b_thres=16,
                            anneal=anneal)
        return deq, params_to(deq_params_from_flax(load_flax_msgpack(
            weights("deq_deconv.msgpack"))), dev)

    def csmri_deq():  # tests/paper/test_csmri_grid.py::test_trained_deq_grid
        x = dp.Variable()
        solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                            + dp.deep_prior(x, get_denoiser("distilled_gray"), sqrt=True,
                                            param_key="deq_prior"), "admm", device=dev)
        deq = dp.specialize(solver, "deq", learned_params=True, f_thres=24, b_thres=16)
        return deq, params_to(deq_params_from_flax(load_flax_msgpack(
            weights("deq_csmri.msgpack"))), dev)

    def csmri_tuner():  # tests/test_specialization.py, the shipped policy
        x = dp.Variable()
        solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                            + dp.deep_prior(x, "tv", sqrt=True), "admm", device=dev)
        tuner = dp.specialize(solver, "rl", action_pack=5, max_episode_step=6)
        tuner.load(weights("autotune_csmri.msgpack"))
        return tuner, solver

    def deconv_tuner():  # scripts/train_autotune_multi.py::build_tuner("deconv")
        x = dp.Variable()
        solver = dp.compile(dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf", batch=False))
                                           - dp.Placeholder("b")) + dp.deep_prior(x, "tv"),
                            "admm", device=dev)

        def pack(variables, x0c, T, aux):
            B, _, H, W = x0c.shape
            amap = torch.as_tensor(np.asarray(aux, np.float32), device=x0c.device)
            return torch.cat([variables, x0c, T, amap[:, :, None, None].expand(B, 2, H, W)], 1)

        tuner = dp.AutoTuneSolver(solver, action_pack=5, max_episode_step=6,
                                  ob_dim=solver.state_dim + 4, custom_policy_ob_pack_fn=pack)
        tuner.load(weights("autotune_deconv.msgpack"))
        return tuner, solver

    def nonneg_deq():  # tests/test_specialization.py:68-84 at 128^2
        from dprox_tpu_torch.utils.imaging import point_spread_function

        gt, y, _ = deq_observation(2.0, 0.01, 0, dev, k=5)
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, point_spread_function(5, 2)) - y),
                             dp.nonneg(x)], "admm", device=dev)
        return dp.specialize(solver, "deq", learned_params=True, f_thres=15, b_thres=15), gt, y

    return {"color_deq": color_deq, "csmri_deq": csmri_deq, "csmri_tuner": csmri_tuner,
            "deconv_tuner": deconv_tuner, "nonneg_deq": nonneg_deq}


def _kernel_ms(fn, calls=10):
    """Device time of one call of ``fn``: the sum of its device kernels'
    durations in a torch.profiler trace of ``calls`` eager calls (the
    Anderson step solves its small system with torch.linalg.solve_ex,
    which a CUDA graph is not known to capture); None where the trace
    holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3 if us else None


def _grad_rel(got, ref):
    return float((got.detach().cpu().double() - ref.detach().cpu().double()).abs().max()
                 / ref.detach().cpu().double().abs().max().clamp(min=1e-300))


def phase_special(dp, kernels, dev, card):
    """The shipped trained solvers through dp.specialize on the card: the
    color DEQ deconvolution (FFDNet nc=96 nb=10 fine-tuned through the
    equilibrium) at its three held-out settings and annealed, the trained
    CS-MRI DEQ on DEQ_GRID's cells, the CS-MRI and deconv tuners; each PSNR
    and Anderson stopping step against the JAX package on the CPU, launch
    counts against the evaluations of f; gradients of training steps (the
    color and the nonneg DEQ through the implicit backward, the unrolled
    solver, the tuner) against the same on the CPU; iteration and step
    times."""
    from dprox_tpu_torch.algo.special import UnrolledSolver, anderson, train_supervised
    from dprox_tpu_torch.algo.special.fixed_point import _mix_weights
    from dprox_tpu_torch.contrib import csmri
    from dprox_tpu_torch.utils.imaging import point_spread_function
    from dprox_tpu_torch.utils.metrics import psnr

    models, cpu_models = _special_models(dp, dev), _special_models(dp, "cpu")
    records, by_path, failed = {}, {}, []
    zero = dict.fromkeys(kernels.launch_counts(), 0)

    def launches_are(name, counts, expected):
        if counts != zero | expected:
            failed.append(f"{name}: launches {counts} != {zero | expected}")

    def psnr_gate(name, got, ref):
        if not abs(got - ref) <= PSNR_TOL_DB:
            failed.append(f"{name}: PSNR {got} vs JAX-CPU {ref}")

    def stop_gate(name, stats, ref, key="forward"):
        """Anderson's stopping step (its evaluations of f) against JAX's;
        on a difference, both residual histories against eps."""
        got = stats[key]["evaluations"]
        if got != ref[f"{key}_evaluations"]:
            failed.append(f"{name} {key}: {got} evaluations, JAX-CPU "
                          f"{ref[f'{key}_evaluations']}; residuals (eps {ANDERSON_EPS}) here "
                          f"{stats[key]['res']}, JAX-CPU {ref[f'{key}_res']}")

    def timed(fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, kernels.launch_counts()

    # the color DEQ at its three held-out settings, then annealed (noiseless)
    deq, params = models["color_deq"]()
    for i, (sig, sn) in enumerate(DEQ_DECONV_CELLS):
        name, ref = f"deq_deconv_{i}", JAX_CPU_SPECIAL[f"deq_deconv_{i}"]
        gt, y, psf = deq_observation(sig, sn, 77 + i, dev)
        stats = []
        out, seconds, counts = timed(lambda: deq.solve(
            x0=y, rhos=0.05 + 5.0 * sn, lams=0.1 + 2.0 * sn, params=dict(params, psf=psf, y=y),
            real_output=True, stats=stats))
        got = psnr(torch.clamp(out, 0, 1), gt)
        n = stats[0]["forward"]["evaluations"]
        records[name] = {"psf_sigma": sig, "noise": sn, "psnr": got, "jax_cpu_psnr": ref["psnr"],
                         "psnr_gap_db": got - ref["psnr"], "evaluations": n,
                         "jax_cpu_evaluations": ref["forward_evaluations"],
                         "last_res": stats[0]["forward"]["res"][-1], "solve_s": seconds,
                         "launches": {k: v for k, v in counts.items() if v}}
        by_path[name] = counts
        psnr_gate(name, got, ref["psnr"])
        stop_gate(name, stats[0], ref)
        launches_are(name, counts, {"freq_divide": n})
    deq12, _ = models["color_deq"](f_thres=2, anneal=12)
    gt, y, psf = deq_observation(5.0, 0.0, 0, dev)
    rhos, sigmas = dp.log_descent(80, 5, 12, sigma=0.001, lam=0.23)
    stats = []
    out, seconds, counts = timed(lambda: deq12.solve(
        x0=y, rhos=rhos, lams=sigmas, params=dict(params, psf=psf, y=y), real_output=True,
        stats=stats))
    got, ref = psnr(torch.clamp(out, 0, 1), gt), JAX_CPU_SPECIAL["deq_deconv_anneal"]["psnr"]
    n = sum(s["forward"]["evaluations"] for s in stats)
    records["deq_deconv_anneal"] = {"levels": 12, "f_thres": 2, "psnr": got, "jax_cpu_psnr": ref,
                                    "psnr_gap_db": got - ref, "evaluations": n,
                                    "solve_s": seconds,
                                    "launches": {k: v for k, v in counts.items() if v}}
    by_path["deq_deconv_anneal"] = counts
    psnr_gate("deq_deconv_anneal", got, ref)
    launches_are("deq_deconv_anneal", counts, {"freq_divide": 24})
    if n != 24:
        failed.append(f"deq_deconv_anneal: {n} evaluations, not 12 x 2")

    # the trained CS-MRI DEQ (no kernel: k-space x-update, a network prior)
    cdeq, cparams = models["csmri_deq"]()
    for lines, sigma in DEQ_CSMRI_CELLS:
        name = f"deq_csmri_{lines}_{sigma}"
        ref = JAX_CPU_SPECIAL[name]
        s = csmri.generate_sample(size=128, num_lines=lines, sigma=sigma)
        stats = []
        out, seconds, counts = timed(lambda: cdeq.solve(
            x0=np.real(s["x0"]).astype(np.float32), rhos=0.3, lams=0.05,
            params=dict(cparams, **s["params"]), real_output=True, stats=stats))
        got = psnr(out, s["gt"])
        records[name] = {"psnr": got, "jax_cpu_psnr": ref["psnr"], "psnr_gap_db": got - ref["psnr"],
                         "evaluations": stats[0]["forward"]["evaluations"],
                         "jax_cpu_evaluations": ref["forward_evaluations"],
                         "last_res": stats[0]["forward"]["res"][-1], "solve_s": seconds,
                         "launches": {k: v for k, v in counts.items() if v}}
        by_path[name] = counts
        psnr_gate(name, got, ref["psnr"])
        stop_gate(name, stats[0], ref)
        launches_are(name, counts, {})

    # the shipped tuners: CS-MRI against log_descent at 30 iterations, deconv
    tuner, solver = models["csmri_tuner"]()
    s = csmri.generate_sample(size=128, num_lines=40, sigma=0.05)
    x0 = np.real(s["x0"]).astype(np.float32)
    tuner.solve(x0, solve_params=s["params"])  # warm
    out, seconds, counts = timed(lambda: tuner.solve(x0, solve_params=s["params"]))
    rhos, sigmas = dp.log_descent(30, 5, 30, sigma=0.01)
    base = psnr(solver.solve(x0=s["x0"], rhos=rhos, lams=sigmas, max_iter=30,
                             params=s["params"], real_output=True), s["gt"])
    ref = JAX_CPU_SPECIAL["autotune_csmri"]
    got = psnr(out.real, s["gt"])
    records["autotune_csmri"] = {
        "tuned_psnr": got, "jax_cpu_tuned_psnr": ref["tuned"], "psnr_gap_db": got - ref["tuned"],
        "log_descent_psnr": base, "jax_cpu_log_descent_psnr": ref["log_descent"],
        "gain_db": got - base, "episode_s": seconds, "episode_its_per_sec": 30 / seconds,
        "launches": {k: v for k, v in counts.items() if v},
        "policy_device": str(next(tuner.policy.parameters()).device)}
    by_path["autotune_csmri"] = counts
    psnr_gate("autotune_csmri", got, ref["tuned"])
    psnr_gate("autotune_csmri log_descent", base, ref["log_descent"])
    launches_are("autotune_csmri", counts, {"tv_denoise_chw": 30})
    if not got > base + 1.0:
        failed.append(f"autotune_csmri: tuned {got} not 1 dB over log_descent {base}")
    dtuner, dsolver = models["deconv_tuner"]()
    gt, b, psf = deq_observation(2.5, 0.0, 0, dev)
    sp = {"b": b, "psf": psf}
    aux = np.asarray([[0.0, 0.25]], np.float32)
    out, seconds, counts = timed(lambda: dtuner.solve(b, aux_state=aux, solve_params=sp))
    rhos, sigmas = dp.log_descent(35, 10, 30)
    base = psnr(torch.clamp(dsolver.solve(x0=b, rhos=rhos, lams=sigmas, max_iter=30, params=sp),
                            0, 1), gt)
    ref = JAX_CPU_SPECIAL["autotune_deconv"]
    got = psnr(torch.clamp(out.real, 0, 1), gt)
    records["autotune_deconv"] = {
        "tuned_psnr": got, "jax_cpu_tuned_psnr": ref["tuned"], "psnr_gap_db": got - ref["tuned"],
        "log_descent_psnr": base, "jax_cpu_log_descent_psnr": ref["log_descent"],
        "episode_s": seconds, "launches": {k: v for k, v in counts.items() if v}}
    by_path["autotune_deconv"] = counts
    psnr_gate("autotune_deconv", got, ref["tuned"])
    psnr_gate("autotune_deconv log_descent", base, ref["log_descent"])
    launches_are("autotune_deconv", counts, {"tv_denoise_chw": 30, "freq_divide": 30})

    # gradients of training steps, card against CPU
    def color_step(device):
        deq_d, p = (deq, params) if device == dev else cpu_models["color_deq"]()
        gt, y, psf = deq_observation(*DEQ_DECONV_CELLS[0], 77, device)
        p = {"deq_r": p["deq_r"].clone().requires_grad_(),
             "deq_l": p["deq_l"].clone().requires_grad_(),
             "deq_prior": {k: v.clone().requires_grad_() for k, v in p["deq_prior"].items()}}
        sn = DEQ_DECONV_CELLS[0][1]
        stats = []
        out = deq_d.solve(x0=y, rhos=0.05 + 5.0 * sn, lams=0.1 + 2.0 * sn,
                          params=dict(p, psf=psf, y=y), real_output=True, stats=stats)
        wrt = {"deq_r": p["deq_r"], "deq_l": p["deq_l"],
               "deq_prior.convs.0.weight": p["deq_prior"]["convs.0.weight"]}
        grads = torch.autograd.grad(torch.mean((out - gt) ** 2), list(wrt.values()))
        return dict(zip(wrt, grads)), stats[0]

    def nonneg_step(device):
        deq_d, gt, y = (models if device == dev else cpu_models)["nonneg_deq"]()
        p = {k: v.requires_grad_() for k, v in deq_d.init_params().items()}
        stats = []
        out = deq_d.solve(x0=y, rhos=0.1, lams=0.05, params=p, stats=stats)
        (g,) = torch.autograd.grad(torch.mean((out - gt) ** 2), [p["deq_r"]])
        return {"deq_r": g}, stats[0]

    def unrolled_steps(device):
        # noiseless: with noise 0.01 a 1e-7 relative change of y moves the
        # CPU's own d loss / d lams by 1.4% (soft-threshold branches), so
        # no card-against-CPU gate could hold there; noiseless, 4e-5
        gt, y, _ = deq_observation(2.0, 0.0, 0, device, k=5)
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, point_spread_function(5, 2)) - y),
                             dp.norm1(dp.grad(x, 0))], "admm", device=device)
        us = UnrolledSolver(solver, max_iter=4, learned_params=True, rhos=0.5, lams=0.05)

        def step(params, batch, generator):
            return torch.mean((us.solve(x0=y, params=params) - gt) ** 2)

        params = us.init_params()
        rho0 = params["unroll_rhos"].clone().requires_grad_()
        lam0 = params["unroll_lams"][0].clone().requires_grad_()
        g = torch.autograd.grad(step({"unroll_rhos": rho0, "unroll_lams": (lam0,)}, None, None),
                                [rho0, lam0])
        trained = train_supervised(step, [None] * 4, params, epochs=1, lr=5e-3, log_every=0)
        return {"d_unroll_rhos": g[0], "d_unroll_lams": g[1],
                "trained_unroll_rhos": trained["unroll_rhos"],
                "trained_unroll_lams": trained["unroll_lams"][0]}, None

    def tuner_step(device):
        t = tuner if device == dev else cpu_models["csmri_tuner"]()[0]
        p = {k: v.requires_grad_() for k, v in t.policy_params.items()}
        loss = torch.mean((t._episode(p, x0, s["params"]).real
                           - torch.from_numpy(s["gt"]).to(device)) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        flat = torch.cat([g.reshape(-1) for g in grads if g is not None])
        return {"policy": flat}, None

    s = csmri.generate_sample(size=128, num_lines=40, sigma=0.05)
    x0 = np.real(s["x0"]).astype(np.float32)
    steps = {"deq_deconv_train_step": (color_step, {"freq_divide"}),
             "deq_nonneg_train_step": (nonneg_step, {"freq_divide", "fused_admm_update"}),
             "unrolled_train_4_steps": (unrolled_steps, {"freq_divide", "fused_admm_update"}),
             "autotune_csmri_train_step": (tuner_step, {"tv_denoise_chw"})}
    for name, (run, used) in steps.items():
        (grads, stats), seconds, counts = timed(lambda: run(dev))
        ref_grads, _ = run("cpu")
        rel = {k: _grad_rel(grads[k], ref_grads[k]) for k in grads}
        rec = {"max_rel_err_vs_cpu": rel, "seconds": seconds,
               "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
               "launches": {k: v for k, v in counts.items() if v}}
        if stats is not None:
            ref = JAX_CPU_SPECIAL[name]
            rec.update(forward_evaluations=stats["forward"]["evaluations"],
                       backward_evaluations=stats["backward"]["evaluations"],
                       jax_cpu_evaluations=[ref["forward_evaluations"],
                                            ref["backward_evaluations"]])
            stop_gate(name, stats, ref)
            stop_gate(name, stats, ref, "backward")
            n = stats["forward"]["evaluations"] + 1
            launches_are(name, counts, dict.fromkeys(used, n))
        elif name == "unrolled_train_4_steps":  # one gradient, then 4 steps: 5 x 4 iterations
            launches_are(name, counts, dict.fromkeys(used, 20))
        else:
            launches_are(name, counts, dict.fromkeys(used, 30))
        records[name] = rec
        by_path[name] = counts
        if not (rec["finite"] and all(v <= GRAD_REL_TOL for v in rel.values())):
            failed.append(f"{name}: gradients {rel} (limit {GRAD_REL_TOL}) or non-finite")

    # times: a training step of the color DEQ, the tuner's train, one f
    # evaluation and one Anderson step against one plain ADMM iteration
    _, step_s, _ = timed(lambda: color_step(dev))
    records["deq_deconv_train_step"]["step_ms"] = step_s * 1e3
    dataset = [{"x0": x0, "gt": s["gt"], **s["params"]}]
    _, train_s, _ = timed(lambda: tuner.train(dataset, epochs=1, log_every=0))
    records["autotune_csmri_train_step"]["train_step_ms"] = train_s * 1e3
    gt, y, psf = deq_observation(*DEQ_DECONV_CELLS[0], 77, dev)
    sn = DEQ_DECONV_CELLS[0][1]
    p = dict(params, psf=psf, y=y)
    solver = deq.internal
    rho = torch.tensor((0.05 + 5.0 * sn) * float(params["deq_r"]), device=dev)
    lam = torch.tensor((0.1 + 2.0 * sn) * float(params["deq_l"]), device=dev)
    with torch.no_grad():
        aux = solver.prepare_aux(y, p)
        z0 = solver.pack(solver.initialize(y, p))

        def f(z):
            return solver.pack(solver._iter(tuple(solver.unpack(z)), rho, [lam], 0, p, aux))

        m, D = 6, z0.numel()
        X = z0.reshape(1, 1, D).repeat(1, m, 1) + 1e-3 * torch.randn(1, m, D, device=dev)
        F = f(z0).reshape(1, 1, D).repeat(1, m, 1)
        rhs = torch.zeros(1, m + 1, 1, device=dev)
        rhs[:, 0] = 1.0

        def anderson_step():  # one full-window update and its f, no stop test
            alpha = _mix_weights(X, F, 1e-4, rhs)
            xk = torch.einsum("bn,bnd->bd", alpha, F)
            F[:, 0] = f(xk.reshape(z0.shape)).reshape(1, D)
            X[:, 0] = xk

        timing = {"f_eager_ms": time_ms(lambda: f(z0), 10, 3, graph=False),
                  "f_device_ms": time_ms(lambda: f(z0), 10, 3),
                  "anderson_step_eager_ms": time_ms(anderson_step, 10, 3, graph=False),
                  "f_kernel_ms": _kernel_ms(lambda: f(z0)),
                  "anderson_step_kernel_ms": _kernel_ms(anderson_step)}
        deq_obs = _marginal(lambda k: anderson(f, z0, threshold=k, eps=-1.0), 8, 24, reps=3,
                            estimates=3)
        # the same steps without the stop test's host read
        noread_obs = _marginal(lambda k: [anderson_step() for _ in range(k)], 8, 24, reps=3,
                               estimates=3)
        r24, l24 = rho.expand(24), lam.expand(24)
        admm_obs = _marginal(lambda k: solver.solve(x0=y, rhos=r24[:k], lams=l24[:k], max_iter=k,
                                                    params=p), 8, 24, reps=3, estimates=3)
    # TV's backward recomputes the plain version under autograd: its cost at
    # the tuners' shape (1x128x128, the "tv" prior's 5 iterations)
    v = torch.rand(1, 128, 128, device=dev, requires_grad=True)
    lam_tv = torch.full((1,), 0.05, device=dev)
    timing["tv_forward_ms"] = time_ms(lambda: kernels.tv_denoise_chw(v.detach(), lam_tv, 5),
                                      10, 3, graph=False)
    timing["tv_forward_backward_ms"] = time_ms(
        lambda: torch.autograd.grad(kernels.tv_denoise_chw(v, lam_tv, 5).sum(), v), 10, 3,
        graph=False)
    timing.update(deq_its_per_sec=statistics.median(deq_obs), deq_obs=deq_obs,
                  admm_its_per_sec=statistics.median(admm_obs), admm_obs=admm_obs,
                  span="8-24", statistic="median of 3 best-of-3")
    timing["anderson_cost_per_iteration"] = (timing["admm_its_per_sec"]
                                             / timing["deq_its_per_sec"] - 1)
    # the stop test's host read: a marginal DEQ step less a marginal step
    # without the read
    timing.update(noread_its_per_sec=statistics.median(noread_obs), noread_obs=noread_obs)
    timing["stop_read_ms_per_step"] = (1e3 / timing["deq_its_per_sec"]
                                       - 1e3 / timing["noread_its_per_sec"])
    records["deq_deconv_timing"] = timing
    emit({"phase": "special", "config": "color DEQ deconv 1x3x128x128 (distilled_color nc=96 "
          "nb=10, deq_deconv weights, f_thres 24, b_thres 16); CS-MRI DEQ 1x1x128x128 "
          "(distilled_gray nc=64 nb=10, deq_csmri); tuners: autotune_csmri, autotune_deconv "
          "(30 iterations)", "psnr_tolerance_db": PSNR_TOL_DB, "grad_tolerance": GRAD_REL_TOL,
          "records": records, "card": card})
    if failed:
        raise AssertionError("special: " + "; ".join(failed))
    return by_path


def blur64(img, psf):
    """``img`` (numpy) blurred circularly by ``psf`` in float64, rounded to
    float32 (scripts/smoke_references.py::blur64)."""
    from dprox_tpu_torch.utils.fft import psf2otf

    otf = psf2otf(np.asarray(psf).squeeze(), img.shape[-2:])
    return np.real(np.fft.ifft2(otf * np.fft.fft2(np.asarray(img, np.float64)))).astype(np.float32)


def hsi_problem(dp, name, prior, gt, srf, dev):
    """(solver, x0) of tests/paper/test_hsi_grid.py::_task (noise 0.05) on the
    cube ``gt``, the deblur observation blurred in float64 with numpy
    (scripts/smoke_references.py::hsi_task); solve 24 iterations with
    hsi_schedule()."""
    from dprox_tpu_torch.utils.imaging import point_spread_function

    B = gt.shape[1]
    x = dp.Variable()
    if name == "deblur":
        psf9 = point_spread_function(9, 2)
        b = _noisy(blur64(gt, psf9))
        data, x0 = dp.sum_squares(dp.conv(x, psf9) - torch.from_numpy(b)), b
    elif name == "sisr":
        psf7 = point_spread_function(7, 2)
        hy, hx0 = sr_observation(gt, psf7, 2)
        data = dp.sisr(x, dp.utils.array(_noisy(hy)),
                       dp.utils.array(np.transpose(psf7, (2, 0, 1))[None]), 2)
        x0 = _noisy(hx0)
    elif name == "misr":
        hb = _noisy(np.einsum("ck,nkp->ncp", srf.T, gt.reshape(1, B, -1)).reshape(1, 3, 64, 64))
        data, x0 = dp.misr(x, dp.utils.array(hb), srf), np.repeat(hb.mean(1, keepdims=True), B, 1)
    else:
        mask = (np.random.RandomState(0).rand(1, B, 64, 64) > 0.5).astype(np.float32)
        hy = _noisy(np.sum(gt * mask, axis=1, keepdims=True))
        data = dp.compress_sensing(x, dp.utils.array(mask), dp.utils.array(hy))
        x0 = np.repeat(hy / (B // 2), B, axis=1)
    solver = dp.compile([data, dp.deep_prior(x, prior, sqrt=True)], "admm", device=dev)
    return solver, torch.from_numpy(np.ascontiguousarray(x0, np.float32)).to(dev)


def hsi_schedule(dp):
    return dp.log_descent(35 + 300 * 0.05, 10 + 200 * 0.05, 24, sigma=0.05)


def derain_pipeline(dp, dev, max_iter=7, n_feat=16, scale=8):
    """scripts/train_derain.py::build in the port: unrolled PGD over
    sum_squares(LearnableDegOp(x), rainy) + unrolled_prior(DGUNet);
    returns (solver, the degradation operator, the prior)."""
    from dprox_tpu_torch.contrib.derain import LearnableDegOp
    from dprox_tpu_torch.models.dgu import DGUDenoiser

    deg = LearnableDegOp(max_step=max_iter - 2)
    x = dp.Variable()
    data = dp.sum_squares(deg.as_linop(x), b=dp.Placeholder("rainy"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the same initial weights in every run
        net = DGUDenoiser(n_feat=n_feat, scale_unetfeats=scale, scale_orsnetfeats=scale)
    prior = dp.unrolled_prior(x, net, max_step=max_iter, param_key="dgu")
    return dp.compile([data, prior], method="pgd", device=dev), deg, prior


def derain_weights(prior, dev):
    """weights/derain_joint.msgpack as the port's params, on ``dev``."""
    from dprox_tpu_torch.algo.base import params_to
    from dprox_tpu_torch.utils.checkpoint import (deg_op_state_dict_from_flax,
                                                  dgu_state_dict_from_flax, load_flax_msgpack)

    tree = load_flax_msgpack(os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights",
                                          "derain_joint.msgpack"))
    return params_to({"deg_op": deg_op_state_dict_from_flax(tree["deg_op"]),
                      "dgu": dgu_state_dict_from_flax(tree["dgu"], prior.params.keys()),
                      "rhos": torch.from_numpy(np.asarray(tree["rhos"], np.float32)),
                      "lams": torch.from_numpy(np.asarray(tree["lams"], np.float32))}, dev)


def derain_crops():
    """{crop index: (ground truth, rainy)} as float32 [1, 3, 64, 64] numpy."""
    with np.load(DERAIN_CROPS) as f:
        return {int(i): (g[None].astype(np.float32) / 255.0, r[None])
                for i, g, r in zip(f["crop_idx"], f["gt"], f["rainy"])}


def derain_solve(solver, p, rainy):
    """scripts/train_derain.py::solve: 7 iterations at the trained schedules."""
    return solver.solve(x0=rainy, max_iter=p["rhos"].shape[0], rhos=p["rhos"], lams=p["lams"],
                        params={"rainy": rainy, "deg_op": p["deg_op"], "dgu": p["dgu"]})


def derain_train_grads(dp, dev, params, img, rainy, max_iter=3, n_feat=8, scale=4):
    """A joint training step of the derain pipeline (by default the setup of
    tests/test_training.py:71-111: 3 unrolled PGD iterations, DGUNet n_feat
    8): loss and its gradients on deg_op, dgu and rhos, for ``params``
    ({deg_op, dgu, rhos, lams}, as numpy or tensors)."""
    from dprox_tpu_torch.algo.base import params_to

    solver, _, _ = derain_pipeline(dp, dev, max_iter=max_iter, n_feat=n_feat, scale=scale)
    p = params_to(params, dev)
    leaf = lambda v: v.detach().clone().requires_grad_(True)  # noqa: E731
    p = {"deg_op": {n: {k: leaf(v) for k, v in sd.items()} for n, sd in p["deg_op"].items()},
         "dgu": {k: leaf(v) for k, v in p["dgu"].items()}, "rhos": leaf(p["rhos"]),
         "lams": p["lams"]}
    leaves = {("deg_op", n, k): v for n, sd in p["deg_op"].items() for k, v in sd.items()}
    leaves.update({("dgu", k): v for k, v in p["dgu"].items()})
    leaves[("rhos",)] = p["rhos"]
    img, rainy = (torch.as_tensor(a).to(dev) for a in (img, rainy))
    out = solver.solve(x0=rainy, max_iter=max_iter, rhos=p["rhos"], lams=p["lams"],
                       params={"rainy": rainy, "deg_op": p["deg_op"], "dgu": p["dgu"]})
    loss = torch.mean((out - img) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _grad_group_rel(got, ref):
    """max |got - ref| / max |ref| over each group (deg_op, dgu, rhos) of
    derain_train_grads' gradients."""
    rel = {}
    for group in ("deg_op", "dgu", "rhos"):
        keys = [k for k in ref if k[0] == group]
        r = torch.cat([ref[k].reshape(-1).cpu() for k in keys]).double()
        g = torch.cat([got[k].reshape(-1).cpu() for k in keys]).double()
        rel[group] = float((g - r).abs().max() / r.abs().max())
    return rel


def _device_kernels(fn, calls=3):
    """Device kernels per call of ``fn`` in a torch.profiler trace of
    ``calls`` calls (None if the trace holds no device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset")))
    return n / calls if n else None


def phase_zoo(dp, kernels, dev, card):
    """The rest of the denoiser zoo on the card: DRUNet and ensemble_tv on
    the flagship deconvolution, the HSI grid, the derain pipeline and its
    training step, and one call of each other zoo model against the CPU."""
    from dprox_tpu_torch.models import OpticsUNet
    from dprox_tpu_torch.proxfn.nlm import nlm_denoise
    from dprox_tpu_torch.proxfn.pnp import FFDNet3DDenoiser, IRCNNDenoiser, UNetDenoiser
    from dprox_tpu_torch.proxfn.pnp.grunet import QRNN3DDenoiser
    from dprox_tpu_torch.proxfn.pnp.prior import get_denoiser
    from dprox_tpu_torch.utils.imaging import point_spread_function
    from dprox_tpu_torch.utils.metrics import mpsnr, psnr

    records, by_path, failed = {}, {}, []
    psf = point_spread_function(15, 5)
    img, b = observation(512, psf, False, dev)
    r48, s48 = dp.log_descent(80, 30, MAIN_ITERS)
    r24, s24 = dp.log_descent(80, 25, 24)
    # (name, prior, x8, iterations, schedules, marginal span, its estimates, TV per iteration)
    cases = [("tiny_drunet_color_tv", "tiny_drunet_color_tv", False, MAIN_ITERS, (r48, s48),
              (8, MAIN_ITERS), (3, 3), 1),
             ("ensemble_tv_x8", "ensemble_tv", True, 24, (r24, s24), (4, 24), (1, 2), 8)]
    for name, prior, x8, n, (rhos, sigmas), (lo, hi), (reps, est), tv_per_it in cases:
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b),
                             dp.deep_prior(x, prior, x8=x8)], "admm", device=dev)
        rec = _gated_solve(kernels, solver, img, b, n, rhos, sigmas, JAX_CPU_ZOO[name],
                           PSNR_TOL_DB, {"tv_denoise_chw": tv_per_it * n, "freq_divide": n})
        by_path[f"zoo_{name}"] = rec["launches"]
        obs = _marginal(lambda k: solver.solve(x0=b, max_iter=k, rhos=rhos[:k], lams=sigmas[:k]),
                        lo, hi, reps=reps, estimates=est)
        rec.update(its_per_sec=statistics.median(obs), obs=obs, span=f"{lo}-{hi}",
                   statistic=f"median of {est} best-of-{reps}",
                   **_iteration_ms(solver, b, rhos[0], sigmas[0]))
        records[name] = rec
        del solver
    # one DRUNet call at 512x512 (four 272x272 quadrants) beside one FFDNet call
    sigma = s48[0].to(dev).reshape(-1)
    drunet = get_denoiser("tiny_drunet_color").to(dev)
    ffdnet = get_denoiser("distilled_color").to(dev)
    with torch.no_grad():
        records["denoiser_call_ms"] = {
            "tiny_drunet_color": time_ms(lambda: drunet.denoise(b, sigma), 10, 3),
            "tiny_drunet_color_eager": time_ms(lambda: drunet.denoise(b, sigma), 10, 3,
                                               graph=False),
            "distilled_color_ffdnet": time_ms(lambda: ffdnet.denoise(b, sigma), 10, 3),
            "distilled_color_ffdnet_eager": time_ms(lambda: ffdnet.denoise(b, sigma), 10, 3,
                                                    graph=False)}
        # the quadrants one after another (as the JAX package runs them)
        # against one batch-4 call of the same network
        quads = torch.rand(4, 4, 272, 272, device=dev)
        records["denoiser_call_ms"].update(
            unetres_one_272=time_ms(lambda: drunet.module(quads[:1]), 10, 3),
            unetres_batch4_272=time_ms(lambda: drunet.module(quads), 10, 3))
    del drunet, ffdnet

    # the HSI grid: one divide an iteration in deblur, no kernel in the others
    gt, srf = synthetic_hsi()
    hwc = lambda a: np.transpose(np.asarray(a)[0], (1, 2, 0))  # noqa: E731
    rhos, sigmas = hsi_schedule(dp)
    for task, prior in HSI_GRID:
        solver, x0 = hsi_problem(dp, task, prior, gt, srf, dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = solver.solve(x0=x0, rhos=rhos, lams=sigmas, max_iter=24)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, ref = mpsnr(hwc(out.real.cpu()), hwc(gt)), JAX_CPU_ZOO[f"hsi_{task}"]
        launches = kernels.launch_counts()
        rec = {"prior": prior, "iterations": 24, "solve_s": seconds, "launches": launches,
               "mpsnr_x": got, "jax_cpu_mpsnr_x": ref, "mpsnr_gap_db": got - ref,
               "golden_db": HSI_GRID_GOLDEN[task],
               "solve_ms_best_of_3": _best_ms(lambda: solver.solve(
                   x0=x0, rhos=rhos, lams=sigmas, max_iter=24), 3)}
        records[f"hsi_{task}"] = rec
        by_path[f"zoo_hsi_{task}"] = launches
        want = dict.fromkeys(launches, 0) | ({"freq_divide": 24} if task == "deblur" else {})
        if not (abs(got - ref) <= PSNR_TOL_DB and launches == want):
            failed.append(f"HSI {task}: {rec}")
        del solver
    noisy_cube = torch.from_numpy(
        gt + 0.03 * np.random.RandomState(3).randn(*gt.shape).astype(np.float32)).to(dev)
    dn = {}
    for kind in ("tiny_grunet", "mid_grunet"):
        den = get_denoiser(kind).to(dev)
        with torch.no_grad():
            dn[kind] = mpsnr(hwc(den.denoise(noisy_cube, torch.tensor([0.03], device=dev)).cpu()),
                             hwc(gt))
            dn[f"{kind}_call_ms"] = time_ms(lambda: den.denoise(
                noisy_cube, torch.tensor([0.03], device=dev)), 10, 3, graph=False)
        if abs(dn[kind] - JAX_CPU_ZOO[f"denoise_{kind}"]) > PSNR_TOL_DB:
            failed.append(f"{kind} denoise mPSNR {dn[kind]} vs JAX-CPU "
                          f"{JAX_CPU_ZOO[f'denoise_{kind}']}")
    records["hsi_denoise_noisy_cube"] = dn
    if not dn["mid_grunet"] > dn["tiny_grunet"]:
        failed.append(f"mid_grunet not above tiny_grunet: {dn}")

    # the trained derain pipeline on the golden crops, and a training step
    solver, _, prior = derain_pipeline(dp, dev)
    p = derain_weights(prior, dev)
    der = {}
    for i, (g, r) in derain_crops().items():
        rainy = torch.from_numpy(r).to(dev)
        kernels.reset_launches()
        with torch.no_grad():
            out = derain_solve(solver, p, rainy)
            ms = _best_ms(lambda: derain_solve(solver, p, rainy), 5)
        got = psnr(torch.clamp(out, 0, 1).cpu(), torch.from_numpy(g))
        der[i] = {"psnr_x": got, "jax_cpu_psnr_x": JAX_CPU_ZOO[f"derain_{i}"],
                  "psnr_gap_db": got - JAX_CPU_ZOO[f"derain_{i}"], "golden_db": DERAIN_GOLDEN[i],
                  "psnr_rainy": psnr(torch.from_numpy(r), torch.from_numpy(g)),
                  "solve_ms": ms, "launches": kernels.launch_counts()}
        by_path[f"zoo_derain_{i}"] = der[i]["launches"]
        if abs(der[i]["psnr_gap_db"]) > PSNR_TOL_DB or any(der[i]["launches"].values()):
            failed.append(f"derain crop {i}: {der[i]}")
    records["derain"] = der
    # a joint training step, card against CPU: gated on a step from the
    # shipped weights on crop 0 (the model a user fine-tunes); the random
    # small setup of tests/test_training.py:71-111 is reported beside the
    # CPU's own spread when its params move by one float32 unit (its
    # MergeBlock's 16x16 Gram matrix has a condition number ~1e4 there, so
    # its gradients move ~1e-3 under rounding alone)
    g0, r0 = derain_crops()[0]
    big = dict(max_iter=7, n_feat=16, scale=8)
    trained = derain_weights(prior, "cpu")
    loss_c, g_card = derain_train_grads(dp, dev, trained, g0, r0, **big)
    loss_h, g_cpu = derain_train_grads(dp, "cpu", trained, g0, r0, **big)
    rel = _grad_group_rel(g_card, g_cpu)
    rng = np.random.RandomState(21)
    _, deg, small = derain_pipeline(dp, "cpu", max_iter=3, n_feat=8, scale=4)
    noise = lambda v: v + 0.01 * torch.from_numpy(rng.randn(*v.shape).astype(np.float32))  # noqa: E731
    tp = {"deg_op": {n: {k: noise(v) for k, v in sd.items()} for n, sd in deg.params.items()},
          "dgu": {k: noise(v) for k, v in small.params.items()},
          "rhos": torch.full((3,), 0.5), "lams": torch.full((3,), 0.1)}
    ulp = lambda v: v * (1 + 2.0 ** -24 * torch.from_numpy(  # noqa: E731
        rng.choice([-1.0, 1.0], v.shape).astype(np.float32)))
    tp_ulp = {"deg_op": {n: {k: ulp(v) for k, v in sd.items()} for n, sd in tp["deg_op"].items()},
              "dgu": {k: ulp(v) for k, v in tp["dgu"].items()}, "rhos": tp["rhos"],
              "lams": tp["lams"]}
    face = _synthetic_face32()
    rainy = np.clip(face + 0.1, 0, 1)
    small_card = derain_train_grads(dp, dev, tp, face, rainy)[1]
    small_cpu = derain_train_grads(dp, "cpu", tp, face, rainy)[1]
    small_ulp = derain_train_grads(dp, "cpu", tp_ulp, face, rainy)[1]
    records["derain_train_step"] = {
        "trained_crop0": {"loss_card": float(loss_c), "loss_cpu": float(loss_h),
                          "grad_rel_err": rel, "limit": DERAIN_GRAD_REL_TOL,
                          "step_ms": _best_ms(lambda: derain_train_grads(
                              dp, dev, trained, g0, r0, **big), 3)},
        "random_small": {"grad_rel_err": _grad_group_rel(small_card, small_cpu),
                         "cpu_one_unit_spread": _grad_group_rel(small_ulp, small_cpu),
                         "step_ms": _best_ms(lambda: derain_train_grads(
                             dp, dev, tp, face, rainy), 3)}}
    if not all(v <= DERAIN_GRAD_REL_TOL for v in rel.values()):
        failed.append(f"derain training gradients card vs CPU: {rel}")

    # one call each of the other zoo models, on the card against the CPU
    rng = np.random.RandomState(22)
    gray = rng.rand(1, 2, 64, 64).astype(np.float32)
    cube = rng.rand(1, 8, 32, 32).astype(np.float32)
    rgb = rng.rand(1, 3, 64, 64).astype(np.float32)
    calls = {"ircnn": (IRCNNDenoiser(1), gray), "unet": (UNetDenoiser(), gray),
             "qrnn3d": (QRNN3DDenoiser(), cube), "ffdnet3d": (FFDNet3DDenoiser(in_nc=9, out_nc=8),
                                                             cube),
             "optics_unet": (OpticsUNet(), rgb), "patch_nlm": (None, rgb)}
    models = {}
    sig_c, sig_d = torch.tensor([0.05]), torch.tensor([0.05], device=dev)
    for name, (model, arr) in calls.items():
        xc, xd = torch.from_numpy(arr), torch.from_numpy(arr).to(dev)
        if name == "patch_nlm":
            fc, fd = (lambda: nlm_denoise(xc, sig_c)), (lambda: nlm_denoise(xd, sig_d))
        elif name == "optics_unet":
            model.eval().requires_grad_(False)
            fc = lambda m=model: m(xc)  # noqa: E731
            mod = copy.deepcopy(model).to(dev)
            fd = lambda m=mod: m(xd)  # noqa: E731
        else:
            fc = lambda m=model: m.denoise(xc, sig_c)  # noqa: E731
            mod = copy.deepcopy(model).to(dev)
            fd = lambda m=mod: m.denoise(xd, sig_d)  # noqa: E731
        with torch.no_grad():
            ref, got = fc(), fd()
            err = float((got.cpu() - ref).abs().max() / max(1.0, float(ref.abs().max())))
            models[name] = {"shape": list(arr.shape), "max_rel_err": err,
                            "eager_ms": time_ms(fd, 5, 2, graph=False),
                            "device_kernels_per_call": _device_kernels(fd, 2)}
        if not err <= 1e-4:
            failed.append(f"{name}: card against CPU {err}")
    # IRCNN picks its weight set on the device: a CUDA graph captures a call
    ircnn = copy.deepcopy(calls["ircnn"][0]).to(dev)
    xg, sg = torch.from_numpy(gray).to(dev), torch.tensor([0.05], device=dev)
    with torch.no_grad():
        ref = ircnn.denoise(xg, sg)
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                graphed = ircnn.denoise(xg, sg)
            g.replay()
            torch.cuda.synchronize()
            models["ircnn"]["cuda_graph_capture"] = bool(torch.equal(graphed, ref))
        except RuntimeError as e:
            models["ircnn"]["cuda_graph_capture"] = f"failed: {e}"
    if models["ircnn"]["cuda_graph_capture"] is not True:
        failed.append(f"IRCNN CUDA-graph capture: {models['ircnn']['cuda_graph_capture']}")
    nlm_big = torch.from_numpy(np.random.RandomState(23).rand(1, 3, 512, 512).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        models["patch_nlm_512"] = {
            "shape": [1, 3, 512, 512],
            "eager_ms": time_ms(lambda: nlm_denoise(nlm_big, sig_d), 3, 1, graph=False),
            "device_ms": time_ms(lambda: nlm_denoise(nlm_big, sig_d), 3, 1),
            "device_kernels_per_call": _device_kernels(lambda: nlm_denoise(nlm_big, sig_d), 1)}
    records["models"] = models
    emit({"phase": "zoo", "config": "tiny_drunet_color_tv (48 it.) and ensemble_tv x8 (24 it.) "
          "on the 1x3x512x512 flagship deconvolution; HSI grid 1x8x64x64 (24 it.); derain "
          "1x3x64x64 (7 it.); the other models at small sizes", "psnr_tolerance_db": PSNR_TOL_DB,
          "records": records, "card": card})
    if failed:
        raise AssertionError("zoo: " + "; ".join(failed))
    return by_path


def _synthetic_face32():
    """The synthetic face's 32x32 crop, [1, 3, 32, 32] float32 numpy."""
    from dprox_tpu_torch.utils.imaging import _synthetic_face

    return np.ascontiguousarray(_synthetic_face(512, 512)[:32, :32].transpose(2, 0, 1)[None],
                                np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import dprox_tpu_torch as dp
    from dprox_tpu_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    emit({"phase": "setup", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": card,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    phase_build(kernels)
    measured = (phase_check(kernels, dev) + phase_check_solver_kernels(kernels, dev)
                + phase_check_bsr(kernels, dev) + phase_check_complex(kernels, dev))
    phase_kernels_per_call(kernels, dev)
    solver, b, launches = phase_main(dp, kernels, dev)
    flagship_its = phase_marginal(dp, solver, b, card)
    del solver, b
    by_path = {"flagship": launches, "nonneg": phase_nonneg(dp, kernels, dev, card)}
    joint = phase_joint(dp, kernels, dev, card)
    by_path.update(joint_cg_pallas=joint["cg_pallas"], joint_default_pcg=joint["default_pcg"])
    phase_grad(dp, kernels, dev, card)
    by_path["lp"] = phase_lp(kernels, dev, card)
    phase_lp_consensus(kernels, dev, card)
    by_path.update(phase_family(dp, kernels, dev, card, flagship_its))
    by_path.update(phase_algos(dp, kernels, dev, card))
    by_path.update(phase_fast(dp, kernels, dev, card))
    by_path.update(phase_special(dp, kernels, dev, card))
    by_path.update(phase_zoo(dp, kernels, dev, card))
    # each kernel's count on the main-path solve that is its own; bsr_matvec
    # has none: every operator a path builds moves fewer bytes as compressed
    # rows (BSRMat.route), and phase check_bsr holds the tile kernel; nor
    # has freq_divide's complex-divisor entry: no path builds a complex
    # divisor (a BlackBox's gram diagonal is |d|^2), check_complex holds it
    own = {"tv_denoise_chw": "flagship", "freq_divide": "flagship",
           "fused_admm_update": "nonneg", "bdot": "joint_cg_pallas",
           "fused_cg_tail": "joint_cg_pallas", "bsr_matvec": None, "csr_matvec": "lp",
           "freq_divide_complex": None}
    for k in measured:
        path = own[k["name"]]
        k["launches_by_path"] = {p: counts[k["name"]] for p, counts in by_path.items()}
        k["launches"] = k["launches_by_path"][path] if path else 0
        k["launches_counted_on"] = path
        if path and k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the {path} path")
        if not path and any(k["launches_by_path"].values()):
            raise AssertionError(f"{k['name']} was launched on a path: {k['launches_by_path']}")
    emit({"kernels": measured})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

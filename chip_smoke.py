#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dprox_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure (any failure
exits non-zero):

1. build    - compile the Hopper kernels from csrc/ with nvcc.
2. check    - hold each kernel against its plain PyTorch version on the
              card, at the main path's shapes and at odd sizes, and time
              kernel, plain version and library call with CUDA events.
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

Then one line {"kernels": [...]}, the nvidia-smi name/power-limit line,
and last {"ok": true, "device": {...}}. float32 convolutions and matmuls
run with TF32 off.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM3 bytes/s and
# float32 (non-tensor-core) operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

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

TV_TOL = 1e-5          # max |kernel - plain|, same op order in float32
DIVIDE_REL_TOL = 1e-6  # max |kernel - plain| / max |plain|
REDUCE_REL_TOL = 1e-5  # bdot and the CG tail: float32 sums in another order
MAIN_ITERS = 48
NONNEG_CAP = 512
JOINT_ITERS = 24


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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
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
    # the flagship's shape (10 iterations), odd sizes, and the joint paths'
    # shape: deep_prior(x, "tv") at 1x3x256x256 runs 5 iterations with one lam
    for shape, it, per_plane in [((3, 512, 512), 10, False), ((1, 37, 53), 10, False),
                                 ((2, 130, 257), 10, True), ((3, 512, 512), 5, False),
                                 ((3, 256, 256), 5, False)]:
        y = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        lam = torch.from_numpy(
            (0.02 + 0.1 * rng.rand(shape[0] if per_plane else 1)).astype(np.float32)).to(dev)
        got = kernels.tv_denoise_chw(y, lam, it)
        ref = kernels.tv_denoise_chw_plain(y, lam, it)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tv_cases.append({"shape": list(shape), "iterations": it, "lam_per_plane": per_plane,
                         "max_abs_err": err})
        if not err <= TV_TOL:
            raise AssertionError(f"tv_denoise_chw {shape} it={it}: max|diff| {err} > {TV_TOL}")

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

    # timings at the main path's shapes
    y = torch.from_numpy(rng.rand(3, 512, 512).astype(np.float32)).to(dev)
    lam = torch.full((1,), 0.05, device=dev)
    n = y.numel()
    tv_bound = bound(2 * 4 * n + 4, n * (16 * (10 - 1) + 6))
    tv = {"name": "tv_denoise_chw", "route": "cuda",
          "source": "dprox_tpu_torch/csrc/tv_denoise.cu",
          "replaces": "dprox_tpu/ops/pallas_kernels.py:388",
          "max_abs_err": max(c["max_abs_err"] for c in tv_cases),
          "ms": time_ms(lambda: kernels.tv_denoise_chw(y, lam, 10)),
          "plain_ms": time_ms(lambda: kernels.tv_denoise_chw_plain(y, lam, 10), 20, 2),
          "bound_ms": tv_bound[0], "bound_by": tv_bound[1], "library_ms": None}
    # the same at the joint paths' shape: 3x256x256, 5 iterations
    yj = torch.from_numpy(rng.rand(3, 256, 256).astype(np.float32)).to(dev)
    tv["at_joint_shape"] = {
        "shape": [3, 256, 256], "iterations": 5,
        "max_abs_err": next(c["max_abs_err"] for c in tv_cases if c["shape"] == [3, 256, 256]),
        "ms": time_ms(lambda: kernels.tv_denoise_chw(yj, lam, 5)),
        "plain_ms": time_ms(lambda: kernels.tv_denoise_chw_plain(yj, lam, 5), 20, 2),
        "bound_ms": bound(2 * 4 * yj.numel() + 4, yj.numel() * (16 * (5 - 1) + 6))[0],
        "bound_by": bound(2 * 4 * yj.numel() + 4, yj.numel() * (16 * (5 - 1) + 6))[1]}
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
    eager_ms = {"tv_denoise_chw": time_ms(lambda: kernels.tv_denoise_chw(y, lam, 10), graph=False),
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

    bdot_cases = []
    for shape in [(1, 3, 256, 256), (1, 3, 512, 512)] + odd:
        a = _randn(rng, shape, dev)
        q = 1.5 * a + 0.1 * _randn(rng, shape, dev)  # <p, q> > 0, as <p, A p> for SPD A
        got, again = kernels.bdot(a, q), kernels.bdot(a, q)
        ref = kernels.bdot_plain(a, q)
        exact = (a.double() * q.double()).flatten(1).sum(1)
        torch.cuda.synchronize()
        rel = float(((got - ref).abs() / ref.abs()).max())
        bdot_cases.append({"shape": list(shape), "max_rel_err": rel,
                           "max_abs_err": float((got - ref).abs().max()),
                           "kernel_rel_gap_to_float64": float(((got - exact).abs() / exact.abs()).max()),
                           "plain_rel_gap_to_float64": float(((ref - exact).abs() / exact.abs()).max())})
        if not rel <= REDUCE_REL_TOL:
            raise AssertionError(f"bdot {shape}: relative diff {rel} > {REDUCE_REL_TOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"bdot {shape}: two calls gave different bits")

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
    n = x.numel()
    b_dot = bound(8 * n + 4, 2 * n)
    dot = {"name": "bdot", "route": "cuda", "source": "dprox_tpu_torch/csrc/bdot.cu",
           "replaces": "dprox_tpu/ops/pallas_kernels.py:227",
           "max_abs_err": bdot_cases[0]["max_abs_err"],
           "ms": time_ms(lambda: kernels.bdot(pp, Ap)),
           "plain_ms": time_ms(lambda: kernels.bdot_plain(pp, Ap)),
           "bound_ms": b_dot[0], "bound_by": b_dot[1],
           "library_ms": time_ms(lambda: torch.linalg.vecdot(pp.flatten(1), Ap.flatten(1)))}
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
          "timing": "CUDA-graph replay, median of 30 x 10 calls (the CG tail is three "
                    "ordinary launches and one graph captures them)",
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
    measured = phase_check(kernels, dev) + phase_check_solver_kernels(kernels, dev)
    solver, b, launches = phase_main(dp, kernels, dev)
    phase_marginal(dp, solver, b, card)
    del solver, b
    by_path = {"flagship": launches, "nonneg": phase_nonneg(dp, kernels, dev, card)}
    joint = phase_joint(dp, kernels, dev, card)
    by_path.update(joint_cg_pallas=joint["cg_pallas"], joint_default_pcg=joint["default_pcg"])
    # each kernel's count on the main-path solve that is its own
    own = {"tv_denoise_chw": "flagship", "freq_divide": "flagship",
           "fused_admm_update": "nonneg", "bdot": "joint_cg_pallas",
           "fused_cg_tail": "joint_cg_pallas"}
    for k in measured:
        k["launches"] = by_path[own[k["name"]]][k["name"]]
        k["launches_counted_on"] = own[k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in by_path.items()}
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the {own[k['name']]} path")
    emit({"kernels": measured})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

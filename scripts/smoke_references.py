#!/usr/bin/env python3
"""JAX-on-CPU reference values of chip_smoke.py's family, algos and fast
phases.

Runs the JAX package (dprox_tpu) on the CPU on the observations the
phases give the port, and prints one JSON object of PSNRs (dB) keyed as
chip_smoke.py's JAX_CPU_FAMILY_PSNR_X, JAX_CPU_ALGOS_PSNR_X and
JAX_CPU_FAST_PSNR_X read them (family's distilled_color_tv is its
JAX_CPU_FLOAT32_AT_BF16_SETTINGS). Run from the repository root (a few
minutes on 8 cores):

    JAX_PLATFORMS=cpu python scripts/smoke_references.py

Observations: the synthetic face _synthetic_face(512, 512) (1x3x512x512),
or its luminance 0.299 R + 0.587 G + 0.114 B (1x1x512x512), blurred
by point_spread_function(15, 5) in float64 with numpy and rounded to
float32, as chip_smoke.py::observation makes them. The fast phase's:
contrib.csmri.generate_sample phantoms at 128x128; the face blurred by
point_spread_function(15, 2), every second pixel kept and upsampled by
the cubic resize, in float64 with numpy (chip_smoke.py::sr_observation);
the 8-band 64x64 cube of examples/papers/hsi_suite.py on the synthetic
face, with the noise of tests/paper/test_hsi_grid.py. The special phase's
(key "special"): the shipped trained solvers (weights/deq_deconv,
deq_csmri, autotune_csmri, autotune_deconv) on the face's 128x128 crop
blurred in float64 with numpy plus numpy noise (deq_observation) and on
the CS-MRI phantoms, with Anderson's evaluations of f and the residuals
its stop test read. Key "cross_task": the per-sample PSNRs that
tests/test_torch_special_golden.py pins for the deconv and demosaic
policies (their samples need sklearn's photographs).

Only the special phase (about 2 minutes) and the cross-task goldens:
    JAX_PLATFORMS=cpu python scripts/smoke_references.py special

Only the optic phase's values (key "optic", JAX_CPU_OPTIC in chip_smoke.py
and the pinned values of tests/test_torch_optic.py): the DOE_GOLDEN crops of
tests/test_optics.py reconstructed through the shipped co-designed optic
(weights/doe_codesign.msgpack) and the Fresnel baseline, as
scripts/train_doe.py's make_reconstruct does, which also writes the crops
(uint8), their two jax.random.normal noise draws and the float32
jnp.geomspace hand schedule to tests/data/doe_golden_crops.npz (~1 min):
    JAX_PLATFORMS=cpu python scripts/smoke_references.py optic

Only the zoo phase's values (key "zoo", JAX_CPU_ZOO in chip_smoke.py and
the pinned values of tests/test_torch_zoo_golden.py), which also writes the
derain golden crops, ground truth and rainy input, that the port reads
(tests/data/derain_golden_crops.npz):
    JAX_PLATFORMS=cpu python scripts/smoke_references.py zoo
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import dprox_tpu as dp  # noqa: E402
from dprox_tpu.utils import imaging, metrics  # noqa: E402
from dprox_tpu.utils.fft import psf2otf  # noqa: E402

LUMA = np.array([0.299, 0.587, 0.114])


def observation(gray):
    img = imaging._synthetic_face(512, 512).transpose(2, 0, 1)[None].astype(np.float64)
    if gray:
        img = np.tensordot(LUMA, img[0], axes=1)[None, None]
    psf = imaging.point_spread_function(15, 5)
    otf = psf2otf(np.asarray(psf).squeeze(), img.shape[-2:])
    b = np.real(np.fft.ifft2(otf * np.fft.fft2(img))).astype(np.float32)
    return img.astype(np.float32), psf, b


def keys_weights(n_in, n_out):
    """[n_in, n_out] float64 weights of jax.image.resize(method="cubic")
    when it upsamples: Keys' kernel (a = -0.5), columns summing to 1."""
    sample = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    w = np.where(x >= 2, 0.0, np.where(x >= 1, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                                       ((1.5 * x - 2.5) * x) * x + 1.0))
    return w / w.sum(0, keepdims=True)


def sr_observation(img, psf, sf):
    """(y, x0) float32: img blurred circularly by psf in float64, every
    sf-th pixel, and its cubic upsampling (chip_smoke.py::sr_observation)."""
    otf = psf2otf(np.asarray(psf).squeeze(), img.shape[-2:])
    y = np.real(np.fft.ifft2(otf * np.fft.fft2(img.astype(np.float64))))[..., ::sf, ::sf]
    h, w = y.shape[-2:]
    x0 = np.einsum("bchw,hH,wW->bcHW", y, keys_weights(h, h * sf), keys_weights(w, w * sf))
    return y.astype(np.float32), x0.astype(np.float32)


def synthetic_hsi(bands=8, size=64):
    rgb = imaging._synthetic_face(512, 512).transpose(2, 0, 1)[:, :size, :size]
    ws = np.stack([np.abs([np.cos(0.2 * b), np.sin(0.15 * b) ** 2, 0.5 + 0.5 * np.cos(0.3 * b)])
                   for b in range(bands)])
    ws = ws / ws.sum(1, keepdims=True)
    return np.einsum("bc,chw->bhw", ws, rgb)[None].astype(np.float32), ws


def noisy(a, sigma=0.05):
    a = np.asarray(a)
    return (a + sigma * np.random.RandomState(5).randn(*a.shape)).astype(np.float32)


def fast():
    """The fast phase's solves (see chip_smoke.py::phase_fast)."""
    from dprox_tpu.contrib import csmri
    from dprox_tpu.proxfn.pnp.denoisers import TVDenoiser

    out = {}
    for lines, sigma in ((50, 0.0), (40, 0.0), (40, 0.05), (30, 0.05)):
        s = csmri.generate_sample(size=128, num_lines=lines, sigma=sigma)
        rhos, sigmas = dp.log_descent(30 + 600 * sigma, 5 + 300 * sigma, 24, sigma=0.01)
        for prior in ("distilled_gray_tv", "tv"):
            x = dp.Variable()
            solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False),
                                         dp.Placeholder("y"))
                                + dp.deep_prior(x, prior, sqrt=True), "admm")
            got = solver.solve(x0=s["x0"], rhos=rhos, lams=sigmas, max_iter=24,
                               params=s["params"], real_output=True)
            out[f"csmri_{prior}_{lines}_{sigma}"] = metrics.psnr(np.asarray(got), s["gt"])
    s = csmri.generate_sample(size=128, num_lines=40)
    x = dp.Variable()
    psi, omega = csmri.CustomADMM.partition(
        [dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y")),
         dp.deep_prior(x, "tv")])
    got = csmri.CustomADMM(psi, omega).solve(x0=s["x0"], max_iter=8, rhos=0.2, lams=0.05,
                                             params=s["params"])
    out["csmri_custom_admm_40_0.0"] = metrics.psnr(np.real(np.asarray(got)), s["gt"])

    img = imaging._synthetic_face(512, 512).transpose(2, 0, 1)[None]
    psf = imaging.point_spread_function(15, 2)
    y, x0 = sr_observation(img, psf, 2)
    x = dp.Variable()
    prob = dp.Problem(dp.sisr(x, dp.utils.array(y), dp.utils.array(np.transpose(psf, (2, 0, 1))[None]),
                              2) + dp.deep_prior(x, "res_ffdnet_color_tv"))
    rhos, sigmas = dp.log_descent(60, 20, 24)
    got = prob.solve(method="admm", x0=jnp.asarray(x0), rhos=rhos, lams=sigmas, max_iter=24)
    out["sisr_res_ffdnet_color_tv"] = metrics.psnr(np.asarray(got), img)
    out["sisr_x0"] = metrics.psnr(x0, img)

    gt, srf = synthetic_hsi()
    B = gt.shape[1]
    hwc = lambda a: np.transpose(np.asarray(a)[0], (1, 2, 0))  # noqa: E731
    for name in ("sisr", "misr", "cs"):
        x = dp.Variable()
        if name == "sisr":
            psf7 = imaging.point_spread_function(7, 2)
            hy, hx0 = sr_observation(gt, psf7, 2)
            data = dp.sisr(x, dp.utils.array(noisy(hy)),
                           dp.utils.array(np.transpose(psf7, (2, 0, 1))[None]), 2)
            hx0 = noisy(hx0)
        elif name == "misr":
            hb = noisy(np.einsum("ck,nkp->ncp", srf.T, gt.reshape(1, B, -1)).reshape(1, 3, 64, 64))
            data = dp.misr(x, dp.utils.array(hb), srf)
            hx0 = np.repeat(hb.mean(1, keepdims=True), B, axis=1)
        else:
            mask = (np.random.RandomState(0).rand(1, B, 64, 64) > 0.5).astype(np.float32)
            hy = noisy(np.sum(gt * mask, axis=1, keepdims=True))
            data = dp.compress_sensing(x, dp.utils.array(mask), dp.utils.array(hy))
            hx0 = np.repeat(hy / (B // 2), B, axis=1)
        solver = dp.compile([data, dp.deep_prior(x, TVDenoiser(iter_num=10, use_3dtv=True),
                                                 sqrt=True)], "admm")
        rhos, sigmas = dp.log_descent(35 + 300 * 0.05, 10 + 200 * 0.05, 24, sigma=0.05)
        got = solver.solve(x0=jnp.asarray(hx0), rhos=rhos, lams=sigmas, max_iter=24)
        out[f"hsi_{name}"] = metrics.mpsnr(hwc(got), hwc(gt))
    return out


DEQ_DECONV_CELLS = [(5.0, 0.01), (5.0, 0.02), (7.0, 0.03)]  # (psf sigma, noise) held out
DEQ_CSMRI_CELLS = [(50, 0.0), (40, 0.05)]  # tests/paper/test_csmri_grid.py::DEQ_GRID


def deq_observation(sig, sn, seed, k=15, size=128):
    """(gt, y, psf [1, 3, k, k]) float32: the face cropped to size, blurred
    circularly by point_spread_function(k, sig) in float64 with numpy, plus
    sn * RandomState(seed) noise (chip_smoke.py::deq_observation)."""
    gt = imaging._synthetic_face(512, 512)[:size, :size].transpose(2, 0, 1)[None]
    psf = imaging.point_spread_function(k, sig)
    otf = psf2otf(np.asarray(psf).squeeze(), (size, size))
    y = np.real(np.fft.ifft2(otf * np.fft.fft2(gt.astype(np.float64))))
    y = y + sn * np.random.RandomState(seed).randn(*y.shape)
    psf13 = np.tile(np.transpose(psf, (2, 0, 1))[None], (1, 3, 1, 1))
    return gt.astype(np.float32), y.astype(np.float32), psf13.astype(np.float32)


class EngineLog:
    """Records each fixed-point solve's evaluations of f and the relative
    residual ||f(x) - x|| / (1e-5 + ||f(x)||) of each, through
    jax.debug.callback. Each engine call traced gets its own slot (a cached
    jit program keeps its slots), and ``take`` groups the evaluations run
    since the last take by slot, in the order they ran (forward, then
    backward)."""

    def __init__(self):
        from dprox_tpu.algo.special import fixed_point

        self.slots = 0
        self.seen = []
        engine = fixed_point.anderson

        def logged(f, x0, **kw):
            slot = self.slots
            self.slots += 1

            def note(x, fx):
                x, fx = np.asarray(x, np.float64), np.asarray(fx, np.float64)
                self.seen.append((slot, float(np.linalg.norm(fx - x)
                                              / (1e-5 + np.linalg.norm(fx)))))

            def g(z):
                out = f(z)
                jax.debug.callback(note, z, out)
                return out

            return engine(g, x0, **kw)

        fixed_point.FIXED_POINT_SOLVERS["anderson"] = logged

    def take(self):
        """[(evaluations, the residuals Anderson's stop test reads: those of
        the 6th evaluation on)] of each slot run since the last take."""
        jax.effects_barrier()
        order = list(dict.fromkeys(slot for slot, _ in self.seen))
        runs = [[r for slot, r in self.seen if slot == s] for s in order]
        self.seen = []
        return [(len(r), r[5:]) for r in runs]


def color_deq(f_thres=24, b_thres=16, anneal=1):
    """scripts/train_deq_deconv.py::build_deq with the shipped weights."""
    from flax import serialization

    from dprox_tpu.algo.special import DEQSolver
    from dprox_tpu.proxfn.pnp.prior import get_denoiser

    den = get_denoiser("distilled_color")
    x = dp.Variable()
    data = dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf"), circular=True),
                          b=dp.Placeholder("y"))
    solver = dp.compile(data + dp.deep_prior(x, den, param_key="deq_prior"), "admm")
    deq = DEQSolver(solver, learned_params=True, f_thres=f_thres, b_thres=b_thres, anneal=anneal)
    params = dict(deq.init_params(), deq_prior=den.params)
    with open(os.path.join(ROOT, "weights", "deq_deconv.msgpack"), "rb") as f:
        return deq, serialization.from_bytes(params, f.read())


def csmri_tuner():
    from flax import serialization

    from dprox_tpu.algo.special import AutoTuneSolver

    x = dp.Variable()
    solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                        + dp.deep_prior(x, "tv", sqrt=True), "admm")
    tuner = AutoTuneSolver(solver, action_pack=5, max_episode_step=6)
    with open(os.path.join(ROOT, "weights", "autotune_csmri.msgpack"), "rb") as f:
        tuner.policy_params = serialization.from_bytes(tuner.policy_params, f.read())
    return solver, tuner


def deconv_tuner():
    """scripts/train_autotune_multi.py's deconv tuner with the shipped
    policy; (tuner, the log_descent baseline's solver)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from flax import serialization

    import train_autotune_multi as M

    tuner = M.build_tuner("deconv")
    with open(os.path.join(ROOT, "weights", "autotune_deconv.msgpack"), "rb") as f:
        tuner.policy_params = serialization.from_bytes(tuner.policy_params, f.read())
    x = dp.Variable()
    solver = dp.compile(dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf", batch=False))
                                       - dp.Placeholder("b")) + dp.deep_prior(x, "tv"), "admm")
    return tuner, solver


def special():
    """The special phase's solves (see chip_smoke.py::phase_special): PSNRs
    and Anderson's evaluations of f with the residuals its stop test read."""
    from dprox_tpu.algo.special import DEQSolver
    from dprox_tpu.contrib import csmri
    from dprox_tpu.proxfn.pnp.prior import get_denoiser

    log = EngineLog()
    out = {}
    deq, params = color_deq()
    for i, (sig, sn) in enumerate(DEQ_DECONV_CELLS):
        gt, y, psf = deq_observation(sig, sn, 77 + i)
        p = dict(params, psf=jnp.asarray(psf), y=jnp.asarray(y))
        got = deq.solve(x0=jnp.asarray(y), rhos=0.05 + 5.0 * sn, lams=0.1 + 2.0 * sn, params=p,
                        real_output=True)
        ((n, res),) = log.take()
        out[f"deq_deconv_{i}"] = {"psnr": metrics.psnr(np.clip(np.asarray(got), 0, 1), gt),
                                  "forward_evaluations": n, "forward_res": res}
    # one training step's gradient (cell 0): the backward's evaluations
    gt, y, psf = deq_observation(*DEQ_DECONV_CELLS[0], 77)
    data = dict(psf=jnp.asarray(psf), y=jnp.asarray(y))
    sn = DEQ_DECONV_CELLS[0][1]
    jax.grad(lambda q: jnp.mean((deq.solve(x0=jnp.asarray(y), rhos=0.05 + 5.0 * sn,
                                           lams=0.1 + 2.0 * sn, params=dict(q, **data),
                                           real_output=True) - gt) ** 2))(params)
    (nf, res_f), (nb, res_b) = log.take()
    out["deq_deconv_train_step"] = {"forward_evaluations": nf, "forward_res": res_f,
                                    "backward_evaluations": nb, "backward_res": res_b}
    # annealed inference, noiseless psf 5: 12 levels x 2 iterations
    deq12, _ = color_deq(f_thres=2, anneal=12)
    gt, y, psf = deq_observation(5.0, 0.0, 0)
    rhos, sigmas = dp.log_descent(80, 5, 12, sigma=0.001, lam=0.23)
    got = deq12.solve(x0=jnp.asarray(y), rhos=np.asarray(rhos, np.float32),
                      lams=np.asarray(sigmas, np.float32),
                      params=dict(params, psf=jnp.asarray(psf), y=jnp.asarray(y)),
                      real_output=True)
    log.take()
    out["deq_deconv_anneal"] = {"psnr": metrics.psnr(np.clip(np.asarray(got), 0, 1), gt)}

    # the trained CS-MRI DEQ on DEQ_GRID's cells
    from flax import serialization

    den = get_denoiser("distilled_gray")
    x = dp.Variable()
    solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                        + dp.deep_prior(x, den, sqrt=True, param_key="deq_prior"), "admm")
    deq = DEQSolver(solver, learned_params=True, f_thres=24, b_thres=16)
    params = {"deq_r": np.float32(1.0), "deq_l": np.float32(1.0), "deq_prior": den.params}
    with open(os.path.join(ROOT, "weights", "deq_csmri.msgpack"), "rb") as f:
        params = serialization.from_bytes(params, f.read())
    for lines, sigma in DEQ_CSMRI_CELLS:
        s = csmri.generate_sample(size=128, num_lines=lines, sigma=sigma)
        got = deq.solve(x0=np.real(s["x0"]).astype(np.float32), rhos=0.3, lams=0.05,
                        params=dict(params, **s["params"]), real_output=True)
        ((n, res),) = log.take()
        out[f"deq_csmri_{lines}_{sigma}"] = {"psnr": metrics.psnr(np.asarray(got), s["gt"]),
                                             "forward_evaluations": n, "forward_res": res}

    # the nonneg DEQ of tests/test_specialization.py at 128^2: a gradient step
    gt, y, _ = deq_observation(2.0, 0.01, 0, k=5)
    x = dp.Variable()
    psf = imaging.point_spread_function(5, 2)
    nn_deq = DEQSolver(dp.compile([dp.sum_squares(dp.conv(x, psf) - jnp.asarray(y)),
                                   dp.nonneg(x)], "admm"), learned_params=True, f_thres=15,
                       b_thres=15)
    jax.grad(lambda q: jnp.mean((nn_deq.solve(x0=jnp.asarray(y), rhos=0.1, lams=0.05, params=q)
                                 - gt) ** 2))(nn_deq.init_params())
    (nf, res_f), (nb, res_b) = log.take()
    out["deq_nonneg_train_step"] = {"forward_evaluations": nf, "forward_res": res_f,
                                    "backward_evaluations": nb, "backward_res": res_b}

    # the shipped tuners: CS-MRI, and deconv on the face
    solver, tuner = csmri_tuner()
    s = csmri.generate_sample(size=128, num_lines=40, sigma=0.05)
    rhos, sigmas = dp.log_descent(30, 5, 30, sigma=0.01)
    base = solver.solve(x0=s["x0"], rhos=rhos, lams=sigmas, max_iter=30, params=s["params"],
                        real_output=True)
    tuned = tuner.solve(np.real(s["x0"]).astype(np.float32), solve_params=s["params"])
    out["autotune_csmri"] = {"tuned": metrics.psnr(np.real(np.asarray(tuned)), s["gt"]),
                             "log_descent": metrics.psnr(np.asarray(base), s["gt"])}
    tuner, solver = deconv_tuner()
    gt, b, psf = deq_observation(2.5, 0.0, 0)
    rhos, sigmas = dp.log_descent(35, 10, 30)
    base = solver.solve(x0=b, rhos=rhos, lams=sigmas, max_iter=30,
                        params={"b": b, "psf": psf})
    tuned = tuner.solve(b, aux_state=np.asarray([[0.0, 0.25]], np.float32),
                        solve_params={"b": b, "psf": psf})
    out["autotune_deconv"] = {
        "tuned": metrics.psnr(np.clip(np.real(np.asarray(tuned)), 0, 1), gt),
        "log_descent": metrics.psnr(np.clip(np.asarray(base), 0, 1), gt)}
    return out


def cross_task_goldens():
    """Per-sample PSNRs of tests/test_specialization.py::
    test_autotune_shipped_policy_cross_task (4 held-out samples of
    scripts/train_autotune_multi.py::make_samples(task, 4, seed0=9000)):
    the shipped policy's, and the baseline that test compares with."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from flax import serialization

    import train_autotune_multi as M

    out = {}
    for task in ("deconv", "demosaic"):
        tuner = M.build_tuner(task)
        with open(os.path.join(ROOT, "weights", f"autotune_{task}.msgpack"), "rb") as f:
            tuner.policy_params = serialization.from_bytes(tuner.policy_params, f.read())
        rows = []
        for sample in M.make_samples(task, 4, seed0=9000):
            if task == "demosaic":
                base = M.baseline_psnr(task, sample)
            else:
                solver = deconv_tuner()[1]
                rhos, sigmas = dp.log_descent(35, 10, M.EPISODE_ITERS)
                got = solver.solve(x0=sample["x0"], rhos=rhos, lams=sigmas,
                                   max_iter=M.EPISODE_ITERS, params=sample["params"])
                base = metrics.psnr(np.clip(np.asarray(got), 0, 1), sample["gt"])
            rows.append([M.tuned_psnr(tuner, sample), base])
        out[task] = rows
    return out


HSI_GRID = [("deblur", "tiny_grunet"), ("sisr", "tiny_grunet"), ("misr", "tiny_grunet_tv"),
            ("cs", "tiny_grunet")]  # tests/paper/test_hsi_grid.py::HSI_GRID
DERAIN_CROPS = (0, 4)  # tests/test_training.py::DERAIN_GOLDEN
DERAIN_FILE = os.path.join(ROOT, "tests", "data", "derain_golden_crops.npz")


def blur64(img, psf):
    """img blurred circularly by psf in float64, rounded to float32."""
    otf = psf2otf(np.asarray(psf).squeeze(), img.shape[-2:])
    return np.real(np.fft.ifft2(otf * np.fft.fft2(np.asarray(img, np.float64)))).astype(np.float32)


def hsi_task(name, prior, gt, srf, sigma_n=0.05):
    """tests/paper/test_hsi_grid.py::_task on the given cube, the deblur
    observation blurred in float64 with numpy (chip_smoke.py::hsi_task);
    returns the mPSNR."""
    B = gt.shape[1]
    x = dp.Variable()
    reg = dp.deep_prior(x, prior, sqrt=True)
    if name == "deblur":
        b = noisy(blur64(gt, imaging.point_spread_function(9, 2)))
        data, x0 = dp.sum_squares(dp.conv(x, imaging.point_spread_function(9, 2)) - b), b
    elif name == "sisr":
        psf7 = imaging.point_spread_function(7, 2)
        hy, hx0 = sr_observation(gt, psf7, 2)
        data = dp.sisr(x, dp.utils.array(noisy(hy)),
                       dp.utils.array(np.transpose(psf7, (2, 0, 1))[None]), 2)
        x0 = noisy(hx0)
    elif name == "misr":
        hb = noisy(np.einsum("ck,nkp->ncp", srf.T, gt.reshape(1, B, -1)).reshape(1, 3, 64, 64))
        data, x0 = dp.misr(x, dp.utils.array(hb), srf), np.repeat(hb.mean(1, keepdims=True), B, 1)
    else:
        mask = (np.random.RandomState(0).rand(1, B, 64, 64) > 0.5).astype(np.float32)
        hy = noisy(np.sum(gt * mask, axis=1, keepdims=True))
        data = dp.compress_sensing(x, dp.utils.array(mask), dp.utils.array(hy))
        x0 = np.repeat(hy / (B // 2), B, axis=1)
    rhos, sigmas = dp.log_descent(35 + 300 * sigma_n, 10 + 200 * sigma_n, 24, sigma=sigma_n)
    got = dp.compile([data, reg], "admm").solve(x0=jnp.asarray(x0), rhos=rhos, lams=sigmas,
                                                max_iter=24)
    hwc = lambda a: np.transpose(np.asarray(a)[0], (1, 2, 0))  # noqa: E731
    return metrics.mpsnr(hwc(jnp.real(got)), hwc(gt))


def derain_crops():
    """The DERAIN_GOLDEN crops (ground truth and JAX's synthetic rain),
    written to DERAIN_FILE: uint8 ground truth, float32 rainy input."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_derain as T

    crops = T.hopper_crops()
    gts, rainy = [], []
    for i in DERAIN_CROPS:
        gt = jnp.asarray(crops[i])[None]
        gts.append(np.rint(np.asarray(crops[i]) * 255.0).astype(np.uint8))
        rainy.append(np.asarray(T.synthetic_rain(gt, jax.random.key(500 + i)))[0])
    gts, rainy = np.stack(gts), np.stack(rainy)
    if not np.array_equal(gts.astype(np.float32) / 255.0, np.stack([crops[i] for i in DERAIN_CROPS])):
        raise AssertionError("hopper crops are not k / 255 in float32")
    os.makedirs(os.path.dirname(DERAIN_FILE), exist_ok=True)
    np.savez_compressed(DERAIN_FILE, crop_idx=np.asarray(DERAIN_CROPS), gt=gts, rainy=rainy)
    return T, gts.astype(np.float32) / 255.0, rainy


def zoo():
    """The zoo phase's solves (see chip_smoke.py::phase_zoo) and the pinned
    values of tests/test_torch_zoo_golden.py."""
    import time

    from dprox_tpu.proxfn.pnp.prior import get_denoiser

    out, seconds = {}, {}
    img, psf, b = observation(False)
    r48, s48 = dp.log_descent(80, 30, 48)
    r24, s24 = dp.log_descent(80, 25, 24)
    data = lambda x: dp.sum_squares(dp.conv(x, psf) - jnp.asarray(b))  # noqa: E731
    t0 = time.time()
    out["tiny_drunet_color_tv"] = metrics.psnr(solve(
        lambda x: [data(x), dp.deep_prior(x, "tiny_drunet_color_tv")], "admm", b, max_iter=48,
        rhos=r48, lams=s48), img)
    seconds["tiny_drunet_color_tv"] = time.time() - t0
    # the CPU golden: the same problem on the 128^2 crop, 24 iterations
    img128 = img[..., :128, :128]
    b128 = blur64(img128, psf)
    out["tiny_drunet_color_tv_128"] = metrics.psnr(solve(
        lambda x: [dp.sum_squares(dp.conv(x, psf) - jnp.asarray(b128)),
                   dp.deep_prior(x, "tiny_drunet_color_tv")], "admm", b128, max_iter=24,
        rhos=r24, lams=s24), img128)
    t0 = time.time()
    out["ensemble_tv_x8"] = metrics.psnr(solve(
        lambda x: [data(x), dp.deep_prior(x, "ensemble_tv", x8=True)], "admm", b, max_iter=24,
        rhos=r24, lams=s24), img)
    seconds["ensemble_tv_x8"] = time.time() - t0

    gt, srf = synthetic_hsi()
    for task, prior in HSI_GRID:
        t0 = time.time()
        out[f"hsi_{task}_{prior}"] = hsi_task(task, prior, gt, srf)
        seconds[f"hsi_{task}"] = time.time() - t0
    noisy_cube = gt + 0.03 * np.random.RandomState(3).randn(*gt.shape).astype(np.float32)
    hwc = lambda a: np.transpose(np.asarray(a)[0], (1, 2, 0))  # noqa: E731
    for kind in ("tiny_grunet", "mid_grunet"):
        den = get_denoiser(kind)
        out[f"denoise_{kind}"] = metrics.mpsnr(hwc(den.denoise(jnp.asarray(noisy_cube), 0.03)),
                                                hwc(gt))

    T, gts, rainy = derain_crops()
    from flax import serialization

    solver, params = T.build()
    with open(os.path.join(ROOT, "weights", "derain_joint.msgpack"), "rb") as f:
        params = serialization.from_bytes(params, f.read())
    for i, gt_i, r in zip(DERAIN_CROPS, gts, rainy):
        t0 = time.time()
        got = T.solve(solver, params, jnp.asarray(r)[None])
        out[f"derain_{i}"] = {"rainy": metrics.psnr(r[None], gt_i[None]),
                              "derained": metrics.psnr(np.clip(np.asarray(got), 0, 1), gt_i[None])}
        seconds[f"derain_{i}"] = time.time() - t0
    out["seconds"] = seconds
    return out


DOE_CROPS = (0, 2)  # tests/test_optics.py::DOE_GOLDEN
DOE_FILE = os.path.join(ROOT, "tests", "data", "doe_golden_crops.npz")


def optic():
    """PSNRs of the DOE_GOLDEN crops through the shipped co-designed optic
    and through the Fresnel baseline (scripts/train_doe.py::evaluate), and
    the data the port needs to make the same observations, written to
    DOE_FILE: the crops as uint8, the standard normal draws of
    jax.random.key(100 + i) and the hand schedule's rhos."""
    import time

    from flax import serialization

    from dprox_tpu.contrib.optic import build_baseline_height_map_sqrt

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_doe as T

    _, model, solver = T.build()
    rhos0, sigmas0 = T.hand_schedule()
    params = {"height_map_sqrt": model.init_params()["height_map_sqrt"], "rhos": rhos0,
              "sigmas": sigmas0}
    with open(os.path.join(ROOT, "weights", "doe_codesign.msgpack"), "rb") as f:
        params = serialization.from_bytes(params, f.read())
    crops = T.hopper_crops()
    recon = T.make_reconstruct(model, solver)
    fresnel = jnp.asarray(build_baseline_height_map_sqrt(model))
    out, gts, noise = {}, [], []
    for i in DOE_CROPS:
        gt = jnp.asarray(crops[i])[None]
        key = jax.random.key(100 + i)
        t0 = time.time()
        out_c = recon(params["height_map_sqrt"], gt, params["rhos"], params["sigmas"], key)
        out_f = recon(fresnel, gt, rhos0, sigmas0, key)
        out[f"doe_{i}"] = {
            "codesign": metrics.psnr(np.clip(np.asarray(out_c), 0, 1), np.asarray(gt)),
            "fresnel": metrics.psnr(np.clip(np.asarray(out_f), 0, 1), np.asarray(gt)),
            "seconds": time.time() - t0}
        gts.append(np.rint(crops[i] * 255.0).astype(np.uint8))
        noise.append(np.asarray(jax.random.normal(key, gt.shape), np.float32))
    gts = np.stack(gts)
    if not np.array_equal(gts.astype(np.float32) / 255.0, np.stack([crops[i] for i in DOE_CROPS])):
        raise AssertionError("hopper crops are not k / 255 in float32")
    np.savez_compressed(DOE_FILE, crop_idx=np.asarray(DOE_CROPS), gt=gts, noise=np.stack(noise),
                        hand_rhos=np.asarray(rhos0, np.float32))
    return out


def solve(fns_of, method, b, **kw):
    x = dp.Variable()
    return np.asarray(dp.compile(fns_of(x), method).solve(x0=jnp.asarray(b), **kw))


def main():
    if sys.argv[1:] == ["special"]:
        print(json.dumps({"special": special(), "cross_task": cross_task_goldens()}, indent=1))
        return
    if sys.argv[1:] == ["optic"]:
        print(json.dumps({"optic": optic()}, indent=1))
        return
    if sys.argv[1:] == ["zoo"]:
        print(json.dumps({"zoo": zoo()}, indent=1))
        return
    out = {"family": {}, "algos": {}}
    img, psf, b = observation(False)
    data = lambda x: dp.sum_squares(dp.conv(x, psf) - jnp.asarray(b))  # noqa: E731
    r24, s24 = dp.log_descent(80, 25, 24)
    r48, s48 = dp.log_descent(80, 30, 48)
    prior = lambda kind, **kw: (lambda x: [data(x), dp.deep_prior(x, kind, **kw)])  # noqa: E731

    fam = out["family"]
    fam["distilled_color_tv_x8"] = metrics.psnr(solve(
        prior("distilled_color_tv", x8=True), "admm", b, max_iter=24, rhos=r24, lams=s24), img)
    # distilled_color_tv: the float32 flagship at the bf16 kind's settings,
    # what a bf16 kind that stayed in float32 would reach
    for kind in ("distilled_color_tv_bf16", "res_ffdnet_color_tv", "distilled_color_tv"):
        fam[kind] = metrics.psnr(solve(prior(kind), "admm", b, max_iter=48, rhos=r48,
                                       lams=s48), img)
    gimg, _, gb = observation(True)
    gdata = lambda x: dp.sum_squares(dp.conv(x, psf) - jnp.asarray(gb))  # noqa: E731
    fam["distilled_gray_tv"] = metrics.psnr(solve(
        lambda x: [gdata(x), dp.deep_prior(x, "distilled_gray_tv")], "admm", gb,
        max_iter=48, rhos=r48, lams=s48), gimg)

    alg = out["algos"]
    nonneg = lambda x: [data(x), dp.nonneg(x)]  # noqa: E731
    for method in ("admm", "ladmm", "admm_vxu", "hqs", "pc", "pgd", "cadmm"):
        kw = {"pc": dict(rhos=1.0, lams=0.1), "pgd": dict(rhos=0.4, lams=0.002)}.get(
            method, dict(rhos=0.05, lams=0.01))
        alg[f"{method}_nonneg"] = metrics.psnr(solve(nonneg, method, b, max_iter=24, **kw), img)
    for method in ("hqs", "admm_vxu"):
        alg[f"{method}_distilled_color_tv"] = metrics.psnr(solve(
            prior("distilled_color_tv"), method, b, max_iter=48, rhos=r48, lams=s48), img)
    x = dp.Variable()
    alg["problem_nonneg"] = metrics.psnr(np.asarray(dp.Problem(data(x) + dp.nonneg(x)).solve(
        x0=jnp.asarray(b), max_iter=24, rhos=0.05, lams=0.01)), img)
    out["psnr_b"] = metrics.psnr(b, img)
    out["psnr_b_gray"] = metrics.psnr(gb, gimg)
    out["fast"] = fast()
    out["special"] = special()
    out["cross_task"] = cross_task_goldens()
    out["zoo"] = zoo()
    out["optic"] = optic()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

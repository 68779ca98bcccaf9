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
face, with the noise of tests/paper/test_hsi_grid.py.
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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


def solve(fns_of, method, b, **kw):
    x = dp.Variable()
    return np.asarray(dp.compile(fns_of(x), method).solve(x0=jnp.asarray(b), **kw))


def main():
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
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

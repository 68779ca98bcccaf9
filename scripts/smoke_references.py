#!/usr/bin/env python3
"""JAX-on-CPU reference values of chip_smoke.py's family and algos phases.

Runs the JAX package (dprox_tpu) on the CPU on the observations the
phases give the port, and prints one JSON object of PSNRs (dB) keyed as
chip_smoke.py's JAX_CPU_FAMILY_PSNR_X and JAX_CPU_ALGOS_PSNR_X read them
(family's distilled_color_tv is its JAX_CPU_FLOAT32_AT_BF16_SETTINGS).
Run from the repository root (about a minute on 8 cores):

    JAX_PLATFORMS=cpu python scripts/smoke_references.py

Observations: the synthetic face _synthetic_face(512, 512) (1x3x512x512),
or its luminance 0.299 R + 0.587 G + 0.114 B (1x1x512x512), blurred
by point_spread_function(15, 5) in float64 with numpy and rounded to
float32, as chip_smoke.py::observation makes them.
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
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

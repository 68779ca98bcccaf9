"""The second slice of the port through dp.compile(...).solve(...) against
the JAX package: nonneg deconvolution (path A: frequency x-update + the
fused ADMM update), joint demosaic + deconvolution through the CG
x-update with the fused tail (path B, ``cg_pallas``) and with the default
config (path B', upgraded to preconditioned CG), and the TV goldens.

Both packages get the same observation b. Tolerances: path A, max abs
1e-4 on x and 1e-3 relative on the residual curves (FFT rounding of the
two CPU backends carried through 24 iterations). Paths B and B', 0.05 dB
on PSNR and a max abs gap on x stated per configuration below: each
x-update is up to 40 float32 CG iterations whose inner products are
summed in another order in the two packages.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu.utils import metrics as jmetrics
from dprox_tpu_torch.utils import imaging, metrics


def _face(h, w):
    return np.ascontiguousarray(imaging._synthetic_face(512, 512)[:h, :w].transpose(2, 0, 1)[None])


@pytest.fixture(scope="module")
def deconv():
    img = _face(64, 64)
    psf = imaging.point_spread_function(15, 5)
    return img, psf, np.array(jimaging.blurring(jnp.asarray(img), psf))


def test_nonneg_deconv_matches_jax(deconv):
    img, psf, b = deconv
    x = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - torch.from_numpy(b)), dp.nonneg(x)],
                        "admm", device="cpu")
    got, res_t = solver.solve_with_residuals(x0=torch.from_numpy(b), max_iter=24,
                                             rhos=0.05, lams=0.01)
    xj = jdp.Variable()
    jsolver = jdp.compile([jdp.sum_squares(jdp.conv(xj, psf) - jnp.asarray(b)), jdp.nonneg(xj)],
                          "admm")
    ref, res_j = jsolver.solve_with_residuals(x0=jnp.asarray(b), max_iter=24,
                                              rhos=0.05, lams=0.01)
    assert got.shape == (1, 3, 64, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    for k in ("r_primal", "r_dual"):
        np.testing.assert_allclose(res_t[k].numpy(), np.asarray(res_j[k]), rtol=1e-3, atol=1e-9)
    assert metrics.psnr(got, img) > metrics.psnr(b, img)


@pytest.mark.parametrize("name", ["norm1", "norm2"])
def test_norm_deconv_matches_jax(deconv, name):
    """norm1 takes the fused soft-threshold route (alpha folded into lam),
    norm2 the generic one."""
    img, psf, b = deconv
    x, xj = dp.Variable(), jdp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - torch.from_numpy(b)),
                         2.0 * getattr(dp, name)(x)], "admm", device="cpu")
    jsolver = jdp.compile([jdp.sum_squares(jdp.conv(xj, psf) - jnp.asarray(b)),
                           2.0 * getattr(jdp, name)(xj)], "admm")
    got = solver.solve(x0=torch.from_numpy(b), max_iter=12, rhos=0.05, lams=0.01)
    ref = jsolver.solve(x0=jnp.asarray(b), max_iter=12, rhos=0.05, lams=0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


JOINT_CONFIGS = {"cg_pallas": dict(max_iters=40, solver_type="cg_pallas"),
                 "default_pcg": dict(max_iters=40)}
# Max abs gap on x allowed after 8 outer iterations, per (config, schedule).
# "bench" is the published schedule, log_descent(35, 10, 8): rho ~ 1e-5
# makes the x-update's system ill-conditioned (~1e5). cg_pallas is cut at
# 40 iterations of a float32 recurrence that amplifies rounding, and pcg
# stops at a residual tolerance that leaves x free by up to tol / rho, so
# the answer is not unique to better than ~1e-2: the JAX solve itself
# moves by 3.6e-3 (cg_pallas) and 7e-3 to 9e-3 (pcg) max abs when b is
# perturbed by one unit in the last place, which
# test_jax_joint_solve_moves_under_one_ulp_of_b reproduces. Measured
# port-to-JAX gap: 2.6e-3 (0.001 dB) and 7.5e-3 (0.015 dB); allowed twice
# that. "rho0.3" is the same problem at a constant rho = 0.3, where both
# solvers converge and the two packages must agree closely: allowed 1e-4
# (measured 2e-6 for both).
JOINT_MAX_ABS = {("cg_pallas", "bench"): 6e-3, ("default_pcg", "bench"): 1.5e-2,
                 ("cg_pallas", "rho0.3"): 1e-4, ("default_pcg", "rho0.3"): 1e-4}


def _joint_observation():
    img = _face(64, 64)
    psf = imaging.point_spread_function(9, 2)
    return img, psf, np.array(jimaging.mosaicing(jimaging.blurring(jnp.asarray(img), psf)))


def _joint_solve(pkg, arr, config, schedule, psf, b):
    x = pkg.Variable()
    data = pkg.sum_squares(pkg.mosaic(pkg.conv(x, psf)) - pkg.Placeholder("b"))
    solver = pkg.compile(data + pkg.deep_prior(x, "tv"), "admm",
                         linear_solve_config=pkg.LinearSolveConfig(**JOINT_CONFIGS[config]),
                         **({"device": "cpu"} if pkg is dp else {}))
    init = pkg.utils.demosaic_from_mosaiced(arr(b))
    rhos, sigmas = pkg.log_descent(35, 10, 8)
    if schedule == "rho0.3":
        rhos = 0.3
    out = solver.solve(x0=init, max_iter=8, rhos=rhos, lams=sigmas, params={"b": arr(b)})
    return np.asarray(out), np.asarray(init)


@pytest.mark.parametrize("schedule", ["bench", "rho0.3"])
@pytest.mark.parametrize("config", list(JOINT_CONFIGS))
def test_joint_demosaic_deconv_matches_jax(config, schedule, monkeypatch):
    from dprox_tpu_torch.linalg import solve as solve_module
    from dprox_tpu_torch.linalg import structured

    matvecs = []  # of the port's x-updates: one per inner iteration, one per set-up
    if config == "cg_pallas":
        solver_fn = solve_module.SOLVERS["cg_pallas"]
        monkeypatch.setitem(
            solve_module.SOLVERS, "cg_pallas",
            lambda A, b, **kw: solver_fn(lambda v: (matvecs.append(1), A(v))[1], b, **kw))
    else:  # pcg on this operator: the structured solve, whose matvec is gram_spectrum
        gram = structured.gram_spectrum
        monkeypatch.setattr(structured, "gram_spectrum",
                            lambda *a: (matvecs.append(1), gram(*a))[1])
    img, psf, b = _joint_observation()
    got, init = _joint_solve(dp, torch.from_numpy, config, schedule, psf, b)
    ref, _ = _joint_solve(jdp, jnp.asarray, config, schedule, psf, b)
    p_t, p_j = metrics.psnr(got, img), jmetrics.psnr(ref, img)
    assert abs(p_t - p_j) <= 0.05
    assert np.abs(got - ref).max() <= JOINT_MAX_ABS[config, schedule]
    assert p_t > metrics.psnr(init, img)  # the solve improves on its bilinear init
    assert 8 < len(matvecs) <= 8 * (40 + 1)  # 8 x-updates ran CG, none past its cap


@pytest.mark.parametrize("config", list(JOINT_CONFIGS))
def test_jax_joint_solve_moves_under_one_ulp_of_b(config):
    """The floor under the "bench" limits above: the reference solve alone
    moves by more than 1e-3 max abs when every nonzero sample of b moves
    to the next float32, so no port can be held to 1e-3 there."""
    img, psf, b = _joint_observation()
    ref, _ = _joint_solve(jdp, jnp.asarray, config, "bench", psf, b)
    moved, _ = _joint_solve(jdp, jnp.asarray, config, "bench", psf,
                            np.where(b != 0, np.nextafter(b, np.float32(2.0)), b))
    assert np.abs(moved - ref).max() > 1e-3


def test_demosaic_golden():
    """tests/test_golden.py::test_demosaic_golden in the port: the
    spatial-diagonal x-update, 25.81 dB +- 0.1."""
    img = torch.from_numpy(_face(128, 128))
    b = imaging.mosaicing(img)
    x = dp.Variable()
    solver = dp.compile(dp.sum_squares(dp.mosaic(x), b=b) + dp.deep_prior(x, "tv"),
                        "admm", device="cpu")
    assert solver.least_square.diagonalizable and not solver.least_square.freq_diagonalizable
    rhos, sigmas = dp.log_descent(35, 10, 24)
    out = solver.solve(x0=dp.utils.demosaic_from_mosaiced(b), rhos=rhos, lams=sigmas, max_iter=24)
    assert metrics.psnr(out, img) == pytest.approx(25.81, abs=0.1)


def test_deconv_tv_golden():
    """tests/test_golden.py::test_deconv_tv_golden[admm] in the port:
    28.01 dB +- 0.1."""
    img = torch.from_numpy(_face(128, 128))
    psf = imaging.point_spread_function(15, 5)
    b = imaging.blurring(img, psf)
    x = dp.Variable()
    solver = dp.compile(dp.sum_squares(dp.conv(x, psf) - b) + dp.deep_prior(x, "tv"),
                        "admm", device="cpu")
    rhos, sigmas = dp.log_descent(35, 10, 24)
    out = solver.solve(x0=b, rhos=rhos, lams=sigmas, max_iter=24)
    assert metrics.psnr(out, img) == pytest.approx(28.01, abs=0.1)


def test_placeholder_value_is_required_and_moved_once(deconv):
    img, psf, b = deconv
    x = dp.Variable()
    solver = dp.compile(dp.sum_squares(dp.conv(x, psf) - dp.Placeholder("b")) + dp.nonneg(x),
                        "admm", device="cpu")
    with pytest.raises(KeyError, match="'b'"):
        solver.solve(x0=b, max_iter=1)
    out = solver.solve(x0=b, max_iter=2, rhos=0.05, lams=0.01, params={"b": b})  # numpy value
    x2 = dp.Variable()
    fixed = dp.compile(dp.sum_squares(dp.conv(x2, psf) - torch.from_numpy(b)) + dp.nonneg(x2),
                       "admm", device="cpu")
    torch.testing.assert_close(out, fixed.solve(x0=b, max_iter=2, rhos=0.05, lams=0.01),
                               rtol=0, atol=0)

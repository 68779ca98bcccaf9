"""The port's ``Problem`` front end, absorb pass, LP dispatch and operator
equilibration against the JAX package's on the CPU.

Tolerances: iterates to atol 1e-5 (constant rho >= 0.05) or 1e-4 (the
log_descent(35, 10) schedule, rho down to ~1e-4: see
test_torch_algorithms.py); the LP to the constraint residual the JAX test
asks (5e-2) and to 1e-2 relative of HiGHS's objective; equilibration
scalings of a diagonal operator, where every Rademacher probe gives the
same magnitudes, to 1e-6 relative of JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu.utils import metrics as jmetrics
from dprox_tpu_torch.proxfn.sum_squares import weighted_sum_squares
from dprox_tpu_torch.utils import metrics


@pytest.fixture(scope="module")
def face64():
    img = np.asarray(jimaging.sample("face"))[:, :, :64, :64].copy()
    psf = jimaging.point_spread_function(15, 5)
    return img, psf, np.array(jimaging.blurring(jnp.asarray(img), psf))


@pytest.mark.parametrize("method", ["admm", "hqs", "ladmm", "admm_vxu", "pc", "pgd", "cadmm"])
def test_problem_solves_imaging_problem_as_jax(face64, method):
    """dp.Problem(data + reg).solve(method=...) on the deconvolution."""
    img, psf, b = face64
    out = {}
    for name, pkg, bb in (("jax", jdp, jnp.asarray(b)), ("torch", dp, torch.from_numpy(b))):
        x = pkg.Variable()
        prob = pkg.Problem(pkg.sum_squares(pkg.conv(x, psf) - bb) + pkg.nonneg(x))
        assert len(prob.objective) == 2
        kw = {} if pkg is jdp else {"device": "cpu"}
        out[name] = np.asarray(prob.solve(method=method, x0=bb, max_iter=12, rhos=0.05,
                                          lams=0.01, **kw))
    assert metrics.psnr(out["torch"], img) > metrics.psnr(b, img)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-5)


def test_problem_with_tv_prior_matches_jax(face64):
    img, psf, b = face64
    out = {}
    for name, pkg, bb in (("jax", jdp, jnp.asarray(b)), ("torch", dp, torch.from_numpy(b))):
        x = pkg.Variable()
        prob = pkg.Problem(pkg.sum_squares(pkg.conv(x, psf) - bb) + pkg.deep_prior(x, "tv"))
        rhos, sigmas = pkg.log_descent(35, 10, 12)
        kw = {} if pkg is jdp else {"device": "cpu"}
        out[name] = np.asarray(prob.solve(x0=bb, max_iter=12, rhos=rhos, lams=sigmas, **kw))
    assert abs(metrics.psnr(out["torch"], img) - jmetrics.psnr(out["jax"], img)) <= 0.01
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-4)


def test_absorb_folds_mosaic_into_weighted_sum_squares(face64):
    """sum_squares(mosaic(x), b) becomes weighted_sum_squares(x) with the
    mosaic as its weight, a psi block with a closed-form prox."""
    img = face64[0]
    b = np.asarray(jimaging.mosaicing(jnp.asarray(img)))
    out = {}
    for name, pkg in (("jax", jdp), ("torch", dp)):
        x = pkg.Variable()
        arr = pkg.utils.array(b) if pkg is jdp else torch.from_numpy(b.copy())
        prob = pkg.Problem(pkg.sum_squares(pkg.mosaic(x), b=arr) + pkg.deep_prior(x, "tv"))
        # the pass appends what it rewrites: [deep_prior, weighted_sum_squares]
        names = [type(f).__name__ for f in prob.objective]
        assert names == ["deep_prior", "weighted_sum_squares"]
        fn = prob.objective[1]
        assert fn.linop is x
        assert not fn.freq
        init = (jdp.utils.demosaic_from_mosaiced(jnp.asarray(b)) if pkg is jdp
                else dp.utils.demosaic_from_mosaiced(torch.from_numpy(b.copy())))
        rhos, sigmas = pkg.log_descent(35, 10, 12)
        kw = {} if pkg is jdp else {"device": "cpu"}
        out[name] = np.asarray(prob.solve(x0=init, max_iter=12, rhos=rhos, lams=sigmas, **kw))
    assert isinstance(prob.objective[1], weighted_sum_squares)
    assert metrics.psnr(out["torch"], img) > 20.0
    assert abs(metrics.psnr(out["torch"], img) - jmetrics.psnr(out["jax"], img)) <= 0.01
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-4)


def test_absorb_folds_scale_into_beta():
    x = dp.Variable()
    fn = dp.nonneg(dp.scale(2.0, x))
    (out,) = dp.optimize([fn])
    assert out is fn and out.linop is x and out.beta == 2.0
    prob = dp.Problem(dp.nonneg(dp.scale(3.0, dp.Variable())), absorb=False)
    assert isinstance(prob.objective[0].linop, dp.scale)
    assert prob.optimize().objective[0].linop is not None


@pytest.mark.parametrize("freq", [False, True])
def test_weighted_sum_squares_prox_matches_jax(face64, freq):
    """The spatial (mosaic) and frequency (conv) weights; the latter
    divides in freq_divide."""
    img, psf, b = face64
    rng = np.random.RandomState(1)
    v = rng.rand(*b.shape).astype(np.float32)
    lam = np.float32(0.07)
    weight = (lambda pkg, x: pkg.conv(x, psf)) if freq else (lambda pkg, x: pkg.mosaic(x))
    xj, xt = jdp.Variable(), dp.Variable()
    fj = jdp.weighted_sum_squares(xj, weight(jdp, xj), jnp.asarray(b))
    ft = weighted_sum_squares(xt, weight(dp, xt), torch.from_numpy(b))
    assert ft.freq == freq
    ref = np.asarray(fj.prox(jnp.asarray(v), jnp.asarray(lam)))
    got = ft.prox(torch.from_numpy(v), torch.tensor(lam))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_problem_dispatches_lp():
    """tests/test_lp.py::test_problem_dispatches_lp in the port, with the
    objective held against HiGHS."""
    from scipy.optimize import linprog

    rng = np.random.RandomState(1)
    n = 10
    c = rng.rand(n) + 0.1
    A = rng.rand(4, n)
    b = A @ rng.rand(n)

    x = dp.Variable()
    objective = c @ x
    assert isinstance(objective, dp.linop.matmul)
    prob = dp.Problem(objective, [A @ x == b])
    assert prob.prox_fns is None and len(prob._lp.A_eq) == 1 and not prob._lp.A_ub
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of tiny ops: one thread (see test_torch_lp_solver.py)
    try:
        sol, history, results = prob.solve(device="cpu", max_iters=3000, pretrain_steps=3,
                                           verbose=False)
    finally:
        torch.set_num_threads(threads)
    sol = np.asarray(sol, np.float64)
    assert np.abs(A @ sol - b).max() < 5e-2
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, None)] * n, method="highs")
    assert abs(c @ sol - ref.fun) <= 1e-2 * abs(ref.fun)


def test_lp_inequalities_dispatch():
    x = dp.Variable()
    A = np.eye(3)
    prob = dp.Problem(np.ones(3) @ x, [A @ x <= np.ones(3), A @ x == np.full(3, 0.5)])
    assert len(prob._lp.A_ub) == 1 and len(prob._lp.A_eq) == 1
    with pytest.raises(NotImplementedError):
        (A @ x) >= np.ones(3)


def test_equilibrate_property_as_jax():
    """tests/test_utils.py::test_equilibrate_runs: finite scalings of the
    input and output shapes. The probes come from a torch.Generator and
    cannot equal JAX's draws; a fixed seed repeats its scalings."""
    x = dp.Variable()
    op = dp.conv(x, jimaging.fspecial_gaussian(5, 2))
    d, e = dp.algo.stochastic_equilibrate(op, (1, 1, 16, 16), iters=3, samples=2,
                                          device="cpu")
    assert tuple(d.shape) == (1, 1, 16, 16) and tuple(e.shape) == (1, 1, 16, 16)
    assert bool(torch.isfinite(d).all()) and bool(torch.isfinite(e).all())
    d2, e2 = dp.algo.stochastic_equilibrate(op, (1, 1, 16, 16), iters=3, samples=2,
                                          device="cpu")
    assert torch.equal(d, d2) and torch.equal(e, e2)
    d3, _ = dp.algo.stochastic_equilibrate(op, (1, 1, 16, 16), iters=3, samples=2,
                                           generator=torch.Generator().manual_seed(1),
                                           device="cpu")
    assert not torch.equal(d, d3)


def test_equilibrate_diagonal_operator_matches_jax():
    """On a diagonal operator |K (d s)| = |k d| for every sign pattern s,
    so the scalings are deterministic and equal JAX's."""
    w = np.random.RandomState(2).uniform(0.5, 4.0, (1, 1, 8, 8)).astype(np.float32)
    dj, ej = jdp.algo.stochastic_equilibrate(
        jdp.mul_elementwise(jdp.Variable(), w), (1, 1, 8, 8), iters=4, samples=3)
    dt, et = dp.algo.stochastic_equilibrate(
        dp.mul_elementwise(dp.Variable(), torch.from_numpy(w)), (1, 1, 8, 8), iters=4, samples=3,
        device="cpu")
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6)


def _imaging_problem():
    x = dp.Variable()
    psf = jimaging.point_spread_function(5, 2)
    return x, dp.sum_squares(dp.conv(x, psf) - torch.zeros(1, 1, 8, 8)) + dp.nonneg(x)


NEW_ENTRY_POINTS = {
    **{f"compile_{m}": (lambda m=m: dp.compile(_imaging_problem()[1], m))
       for m in ("ladmm", "admm_vxu", "hqs", "pc", "pgd", "cadmm")},
    "problem_solve": lambda: dp.Problem(_imaging_problem()[1]).solve(
        x0=torch.zeros(1, 1, 8, 8), max_iter=1),
    "problem_lp_solve": lambda: dp.Problem(np.ones(3) @ dp.Variable(), []).solve(verbose=False),
    "stochastic_equilibrate": lambda: dp.algo.stochastic_equilibrate(
        dp.conv(dp.Variable(), jimaging.point_spread_function(5, 2)), (1, 1, 8, 8), iters=1),
    "est_CompGraph_norm": lambda: dp.linop.est_CompGraph_norm(
        dp.grad(dp.Variable(), 0), shape=(1, 1, 8, 8)),
}


@pytest.mark.parametrize("name", sorted(NEW_ENTRY_POINTS))
def test_new_entry_point_defaults_to_cuda_and_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NEW_ENTRY_POINTS[name]()

"""The port's solvers against the JAX package's on the CPU.

The cases of tests/test_golden.py (GOLDEN_DECONV) and tests/test_algorithms.py
(the six methods, per-sample schedules and lam dicts, consensus ADMM, the
non-image shapes), each on the same numpy observation in both packages.

Tolerances: final iterates to atol 1e-5 at a constant rho of 0.05 or more
(FFT rounding of the two CPU backends carried through 24 iterations;
measured <= 3e-6) and to 1e-4 under the TV prior's log_descent(35, 10)
schedule, whose rho falls to ~1e-4, where the x-update's division by
|H|^2 + rho amplifies that rounding (as in test_torch_slice.py), PSNRs to
0.01 dB of JAX and 0.1 dB of the golden pins, ``est_CompGraph_norm`` to
1e-3 relative (different random probes, both converged), and
``get_rho_sigma_admm`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu.utils import metrics as jmetrics
from dprox_tpu_torch.utils import metrics

X_TOL = 1e-5
X_TOL_PNP = 1e-4


@pytest.fixture(scope="module")
def face128():
    img = np.asarray(jimaging.sample("face"))[:, :, :128, :128].copy()
    psf = jimaging.point_spread_function(15, 5)
    return img, psf, np.array(jimaging.blurring(jnp.asarray(img), psf))


def _both(face, build, method, solve_kw, **compile_kw):
    """(port output, JAX output) of ``build(pkg, b)`` compiled with
    ``method`` and solved from x0 = b."""
    img, psf, b = face
    sj = jdp.compile(build(jdp, psf, jnp.asarray(b)), method=method, **compile_kw)
    st = dp.compile(build(dp, psf, torch.from_numpy(b)), method=method, device="cpu",
                    **compile_kw)
    ref = np.asarray(sj.solve(x0=jnp.asarray(b), **solve_kw))
    got = st.solve(x0=torch.from_numpy(b), **solve_kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == b.shape
    return got.numpy(), ref


def _nonneg(pkg, psf, b):
    x = pkg.Variable()
    return [pkg.sum_squares(pkg.conv(x, psf) - b), pkg.nonneg(x)]


def _tv_prior(pkg, psf, b):
    x = pkg.Variable()
    return pkg.sum_squares(pkg.conv(x, psf) - b) + pkg.deep_prior(x, "tv")


GOLDEN_DECONV = {"admm": 28.01, "hqs": 28.00, "admm_vxu": 28.02}  # tests/test_golden.py


@pytest.mark.parametrize("method", list(GOLDEN_DECONV))
def test_deconv_tv_golden(face128, method):
    rhos, sigmas = dp.log_descent(35, 10, 24)
    got, ref = _both(face128, _tv_prior, method,
                     dict(rhos=rhos.numpy(), lams=sigmas.numpy(), max_iter=24))
    img = face128[0]
    p_t, p_j = metrics.psnr(got, img), jmetrics.psnr(ref, img)
    assert p_t == pytest.approx(GOLDEN_DECONV[method], abs=0.1), (method, p_t)
    assert abs(p_t - p_j) <= 0.01, (p_t, p_j)
    np.testing.assert_allclose(got, ref, rtol=0, atol=X_TOL_PNP)


@pytest.mark.parametrize("method", ["admm", "ladmm", "admm_vxu", "hqs", "pc", "pgd"])
def test_algorithms_improve_psnr(face128, method):
    """tests/test_algorithms.py::test_algorithms_improve_psnr, with the
    final x held against JAX's."""
    kw = dict(max_iter=24, rhos=0.05, lams=0.01)
    if method == "pc":
        kw.update(rhos=1.0, lams=0.1)
    if method == "pgd":
        kw.update(rhos=0.4, lams=0.002)
    got, ref = _both(face128, _nonneg, method, kw)
    img, _, b = face128
    assert metrics.psnr(got, img) > metrics.psnr(b, img) + 0.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=X_TOL)


def test_solver_classes_and_partitions(face128):
    img, psf, b = face128
    fns = _nonneg(dp, psf, torch.from_numpy(b))
    classes = {"admm": dp.ADMM, "ladmm": dp.LinearizedADMM, "admm_vxu": dp.ADMM_vxu,
               "hqs": dp.HQS, "pc": dp.PockChambolle, "pgd": dp.ProximalGradientDescent,
               "cadmm": dp.algo.ConsensusADMM}
    for method, cls in classes.items():
        s = dp.compile(fns, method, device="cpu")
        assert type(s) is cls and s.device == torch.device("cpu")
    assert dp.compile(fns, "pc", device="cpu").least_square.freq_diagonalizable
    pgd = dp.compile(fns, "pgd", device="cpu")
    assert pgd.diff_fn is fns[0] and pgd.prox_fn is fns[1]
    with pytest.raises(ValueError, match="exactly two"):
        dp.compile(fns + [dp.norm1(fns[1].linop)], "pgd", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        dp.compile(fns, "sgd", device="cpu")


def test_sum_squares_grad_matches_jax(face128):
    img, psf, b = face128
    x = np.random.RandomState(0).rand(*b.shape).astype(np.float32)
    ref = jdp.sum_squares(jdp.conv(jdp.Variable(), psf) - jnp.asarray(b)).grad(jnp.asarray(x))
    got = dp.sum_squares(dp.conv(dp.Variable(), psf) - torch.from_numpy(b)).grad(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_per_sample_schedules(face128):
    """tests/test_algorithms.py::test_per_sample_schedules against JAX."""
    img, psf, b = face128
    b2 = np.concatenate([b, b], axis=0)
    rhos = np.stack([np.full(6, 0.05), np.full(6, 0.5)], axis=0)  # [2, 6]
    got, ref = _both((img, psf, b2), _nonneg, "admm", dict(max_iter=6, rhos=rhos, lams=0.01))
    assert got.shape[0] == 2
    assert not np.allclose(got[0], got[1], atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=X_TOL)


def test_multiple_psi_fns_and_lam_dict(face128):
    """tests/test_algorithms.py::test_multiple_psi_fns_and_lam_dict against JAX."""
    img, psf, b = face128
    out = {}
    for name, pkg, bb in (("jax", jdp, jnp.asarray(b)), ("torch", dp, torch.from_numpy(b))):
        x = pkg.Variable()
        data = pkg.sum_squares(pkg.conv(x, psf) - bb)
        tv = pkg.norm1(pkg.grad(x, 0) + pkg.grad(x, 1))
        pos = pkg.nonneg(x)
        kw = {} if pkg is jdp else {"device": "cpu"}
        solver = pkg.compile([data, tv, pos], method="admm", **kw)
        assert len(solver.psi_fns) == 2
        out[name] = np.asarray(solver.solve(x0=bb, max_iter=12, rhos=0.5,
                                            lams={tv: 0.005, pos: 0.01}))
    assert metrics.psnr(out["torch"], img) > metrics.psnr(b, img)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=X_TOL)


class TestConsensusADMM:
    """tests/test_algorithms.py::TestConsensusADMM in the port."""

    def test_two_quadratics_exact(self):
        rng = np.random.RandomState(0)
        b1 = torch.from_numpy(rng.rand(1, 1, 8, 8).astype(np.float32))
        b2 = torch.from_numpy(rng.rand(1, 1, 8, 8).astype(np.float32))
        x = dp.Variable()
        s = dp.compile([dp.sum_squares(x - b1), dp.sum_squares(x - b2)], method="cadmm",
                       device="cpu")
        out = s.solve(x0=torch.zeros_like(b1), max_iter=100, rhos=1.0, lams=0.1)
        assert float((out - (b1 + b2) / 2).abs().max()) < 1e-5

    def test_deconv_improves_psnr(self, face128):
        got, ref = _both(face128, _nonneg, "cadmm", dict(max_iter=24, rhos=0.05, lams=0.01))
        img, _, b = face128
        assert metrics.psnr(got, img) > metrics.psnr(b, img) + 0.5
        np.testing.assert_allclose(got, ref, rtol=0, atol=X_TOL)

    def test_prior_ensemble_consensus_equilibrium(self, face128):
        img, psf, b = face128

        def build(pkg, psf, bb):
            x = pkg.Variable()
            return [pkg.sum_squares(pkg.conv(x, psf) - bb), pkg.deep_prior(x, "tv"),
                    pkg.nonneg(x)]

        out = {}
        for name, pkg, bb in (("jax", jdp, jnp.asarray(b)), ("torch", dp, torch.from_numpy(b))):
            fns = build(pkg, psf, bb)
            kw = {} if pkg is jdp else {"device": "cpu"}
            solver = pkg.compile(fns, method="cadmm", **kw)
            out[name] = np.asarray(solver.solve(x0=bb, max_iter=24, rhos=0.05,
                                                lams={fns[1]: 0.02, fns[2]: 0.01}))
        assert metrics.psnr(out["torch"], img) > metrics.psnr(b, img) + 0.5
        np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=X_TOL)

    def test_residual_tracking(self, face128):
        img, psf, b = face128
        solver = dp.compile(_nonneg(dp, psf, torch.from_numpy(b)), method="cadmm", device="cpu")
        out, res = solver.solve_with_residuals(x0=torch.from_numpy(b), max_iter=30,
                                               rhos=0.05, lams=0.01)
        jsolver = jdp.compile(_nonneg(jdp, psf, jnp.asarray(b)), method="cadmm")
        _, jres = jsolver.solve_with_residuals(x0=jnp.asarray(b), max_iter=30,
                                               rhos=0.05, lams=0.01)
        rp = res["r_primal"].numpy()
        assert np.all(np.isfinite(rp)) and rp[-1] < rp[0]
        for k in ("r_primal", "r_dual"):
            # r_dual's second entry is ~8e-8, at float32's rounding of the sums
            np.testing.assert_allclose(res[k].numpy(), np.asarray(jres[k]), rtol=1e-3,
                                       atol=1e-9)

    def test_rejects_nonquadratic_composite_linop(self, face128):
        img, psf, b = face128
        x = dp.Variable()
        fns = [dp.sum_squares(x - torch.from_numpy(b)), dp.norm1(dp.grad(x, 0))]
        with pytest.raises(ValueError):
            dp.compile(fns, method="cadmm", device="cpu")


def test_non_consensus_algorithms_raise(face128):
    img, psf, b = face128
    for method in ("hqs", "pc", "pgd"):
        solver = dp.compile(_nonneg(dp, psf, torch.from_numpy(b)), method=method, device="cpu")
        with pytest.raises(NotImplementedError):
            solver.solve_with_residuals(x0=torch.from_numpy(b), max_iter=2)


class TestMLProblemShapes:
    """tests/test_algorithms.py::TestMLProblemShapes: exact tiny
    least-squares recovery on non-image shapes through ``Problem``."""

    def test_lsq_matrix_2d(self):
        rhs = np.array([[1., 2, 3], [4, 5, 6], [7, 8, 9]], np.float32)
        x = dp.Variable()
        out = dp.Problem(dp.sum_squares(2 * x - rhs)).solve(
            method="admm", device="cpu", x0=torch.zeros((3, 3)), max_iter=50,
            rhos=1.0, lams=0.1)
        np.testing.assert_allclose(out.numpy(), rhs / 2, atol=1e-5)

    def test_lsq_vector_1d(self):
        rhs = np.array([1., 2, 3], np.float32)
        x = dp.Variable()
        out = dp.Problem(dp.sum_squares(2 * x - rhs)).solve(
            method="admm", device="cpu", x0=torch.zeros(3), max_iter=50, rhos=1.0, lams=0.1)
        np.testing.assert_allclose(out.numpy(), rhs / 2, atol=1e-5)

    def test_lsq_conv_small(self):
        rng = np.random.RandomState(0)
        rhs = torch.from_numpy(rng.rand(1, 1, 8, 8).astype(np.float32))
        kernel = np.ones((3, 3), np.float32) / 9.0
        x = dp.Variable()
        K = dp.conv(x, kernel)
        out = dp.Problem(dp.sum_squares(K - rhs)).solve(
            method="admm", device="cpu", x0=torch.zeros((1, 1, 8, 8)), max_iter=60,
            rhos=0.5, lams=0.1)
        resid = dp.linop.eval(K, out) - rhs
        assert float(resid.abs().max()) < 1e-3


def test_est_comp_graph_norm_matches_jax():
    psf = jimaging.point_spread_function(5, 2)
    ops = {"scale": lambda pkg: pkg.scale(3.0, pkg.Variable()),
           "grad": lambda pkg: pkg.grad(pkg.Variable(), 0),
           "conv": lambda pkg: pkg.conv(pkg.Variable(), psf)}
    for name, make in ops.items():
        ref = jdp.linop.est_CompGraph_norm(make(jdp), shape=(1, 1, 16, 16), iters=200)
        got = dp.linop.est_CompGraph_norm(make(dp), tol=1e-3, shape=(1, 1, 16, 16), iters=200,
                                          device="cpu")
        assert abs(got - ref) <= 1e-3 * ref, (name, got, ref)
    x = dp.Variable()
    assert dp.copy(x) is x


def test_split_is_vstack_transposed():
    x = dp.Variable()
    a, c = dp.scale(2.0, x), dp.grad(x, 1)
    y = torch.rand(1, 1, 6, 6)
    fwd = dp.vstack([a, c]).forward_list({x.name: y})
    back = dp.split([a, c]).forward_list(fwd)
    ref = dp.vstack([a, c]).adjoint_list(fwd)
    torch.testing.assert_close(back[x.name], ref[x.name], rtol=0, atol=0)
    assert len(dp.split([a, c]).adjoint_list({x.name: y})) == 2


def test_get_rho_sigma_admm_exact():
    for kw in ({}, dict(sigma=0.01, iter_num=24, modelSigma1=80.0, modelSigma2=5.0,
                        w=0.5, lam=0.3)):
        rj, sj = jdp.algo.get_rho_sigma_admm(**kw)
        rt, st = dp.algo.get_rho_sigma_admm(**kw)
        assert rt.dtype == torch.float32 and st.dtype == torch.float32
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_specialize_train_visualize_name_their_items():
    """specialize and train came with Queue 1 item 5 (held against the JAX
    package in tests/test_torch_special.py): each name dispatches as the
    JAX package's does. visualize renders the proxfns' linop trees as dot
    source, None without proxfns (its strings are held against the JAX
    package's in tests/test_torch_utils_parity.py)."""
    assert dp.visualize(None) is None
    x = dp.Variable()
    assert dp.visualize(dp.nonneg(x)).startswith("digraph linop {")
    b = np.ones((1, 3, 8, 8), np.float32)
    solver = dp.compile([dp.sum_squares(dp.conv(x, np.ones((3, 3, 1), np.float32) / 9) - b),
                         dp.nonneg(x)], "admm", device="cpu")
    for method, kind in (("deq", dp.DEQSolver), ("rl", dp.AutoTuneSolver)):
        assert isinstance(dp.specialize(solver, method), kind)
    assert isinstance(dp.specialize(solver, "unroll", share=False), dp.UnrolledSolver)
    with pytest.raises(KeyError):
        dp.specialize(solver, "item 5")
    params = dp.train(step_fn=lambda p, batch, generator: ((p["a"] - 1.0) ** 2).sum(),
                      dataset=[None], init_params={"a": torch.zeros(2)}, epochs=1, lr=0.1,
                      log_every=0)
    assert bool(torch.all(params["a"] > 0))

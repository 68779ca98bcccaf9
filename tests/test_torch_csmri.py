"""CS-MRI in the port against the JAX package on the CPU: the synthetic
problems, complex solver states and the contrib module.

The CS-MRI TV golden of tests/test_golden.py and two cells of the
tests/paper/test_csmri_grid.py grid with the distilled_gray_tv prior, each
on the same phantom in both packages, CustomADMM, the .mat loader, and the
complex-state rules (real output, a real lam, a nonneg block raises).

Tolerances: ``generate_sample`` bit for bit (the same numpy code); PSNRs
within 0.01 dB of JAX (the solves agree to ~2e-7 in x, two CPU FFTs'
rounding) and 0.1 dB of the goldens (0.15 on the grid, as the grid test
allows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.contrib import csmri as jcsmri
from dprox_tpu_torch.contrib import csmri
from dprox_tpu_torch.utils import metrics


@pytest.mark.parametrize("kw", [dict(size=32, num_lines=12), dict(size=64, num_lines=30, sigma=0.05,
                                                                   seed=3),
                                dict(size=16, num_lines=8, gt=np.linspace(0, 1, 256).reshape(16, 16))])
def test_generate_sample_is_bit_equal_to_jax(kw):
    got, ref = csmri.generate_sample(**kw), jcsmri.generate_sample(**kw)
    assert set(got) == set(ref)
    for k in ("y0", "x0", "ATy0", "gt", "mask"):
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    for k in ("y", "mask"):
        assert np.array_equal(got["params"][k], ref["params"][k]), k
    assert np.array_equal(csmri.radial_mask((24, 20), 7, 2), jcsmri.radial_mask((24, 20), 7, 2))
    assert np.array_equal(csmri.shepp_logan(40), jcsmri.shepp_logan(40))


def _solve(pkg, s, prior, schedule, max_iter=24):
    x = pkg.Variable()
    y = pkg.Placeholder("y")
    mask = pkg.Placeholder("mask", batch=False)
    kw = {} if pkg is jdp else {"device": "cpu"}
    solver = pkg.compile(pkg.csmri(x, mask, y) + pkg.deep_prior(x, prior, sqrt=True),
                         method="admm", **kw)
    rhos, sigmas = schedule(pkg)
    out = solver.solve(x0=s["x0"], rhos=rhos, lams=sigmas, max_iter=max_iter,
                       params=s["params"], real_output=True)
    return np.asarray(out)


def test_csmri_tv_golden_matches_jax():
    s = csmri.generate_sample(size=128, num_lines=40)
    schedule = lambda pkg: pkg.log_descent(30, 5, 24, sigma=0.01)  # noqa: E731
    got = _solve(dp, s, "tv", schedule)
    ref = _solve(jdp, s, "tv", schedule)
    assert got.dtype == np.float32 and got.shape == (1, 1, 128, 128)
    p_got, p_ref = metrics.psnr(got, s["gt"]), metrics.psnr(ref, s["gt"])
    assert p_got == pytest.approx(p_ref, abs=0.01), (p_got, p_ref)
    assert p_got == pytest.approx(25.71, abs=0.1), p_got


@pytest.mark.parametrize("num_lines,sigma,golden", [(50, 0.0, 30.75), (40, 0.05, 22.76)])
def test_csmri_grid_cell_with_distilled_gray_tv_matches_jax(num_lines, sigma, golden):
    """tests/paper/test_csmri_grid.py::_solve_pnp with its noise-adaptive
    schedule."""
    s = csmri.generate_sample(size=128, num_lines=num_lines, sigma=sigma)
    schedule = lambda pkg: pkg.log_descent(30 + 600 * sigma, 5 + 300 * sigma, 24,  # noqa: E731
                                           sigma=0.01)
    got = _solve(dp, s, "distilled_gray_tv", schedule)
    ref = _solve(jdp, s, "distilled_gray_tv", schedule)
    p_got, p_ref = metrics.psnr(got, s["gt"]), metrics.psnr(ref, s["gt"])
    assert p_got == pytest.approx(p_ref, abs=0.01), (p_got, p_ref)
    assert p_got == pytest.approx(golden, abs=0.15), p_got
    assert p_got > metrics.psnr(np.real(s["x0"]), s["gt"]) + 2.0


def test_custom_admm_matches_jax():
    """tests/test_optics.py::test_csmri_custom_admm: the prox-first order
    through the fused k-space solve, complex state, complex output."""
    s = csmri.generate_sample(size=64, num_lines=30)
    outs = []
    for pkg, cls in ((dp, csmri.CustomADMM), (jdp, jcsmri.CustomADMM)):
        x = pkg.Variable()
        fns = [pkg.csmri(x, pkg.Placeholder("mask", batch=False), pkg.Placeholder("y")),
               pkg.deep_prior(x, "tv")]
        psi, omega = cls.partition(fns)
        solver = cls(psi, omega, device="cpu") if pkg is dp else cls(psi, omega)
        assert not isinstance(solver.least_square, pkg.least_squares)  # the fused solve
        out = solver.solve(x0=s["x0"], max_iter=8, rhos=0.2, lams=0.05, params=s["params"])
        outs.append(np.asarray(out))
    got, ref = outs
    assert np.iscomplexobj(got) and got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-5
    p_in = metrics.psnr(np.real(s["x0"]), s["gt"])
    assert metrics.psnr(np.real(got), s["gt"]) > p_in


def test_admm_state_is_complex_and_output_real_on_request():
    s = csmri.generate_sample(size=32, num_lines=12)
    x = dp.Variable()
    solver = dp.compile([dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y")),
                         dp.deep_prior(x, "tv")], method="admm", device="cpu")
    real_x0 = np.ascontiguousarray(np.real(s["x0"]))
    state = solver.initialize(solver._prepare_x0(real_x0), {})
    assert all(t.dtype == torch.complex64 for t in (state[0], *state[1], *state[2]))
    kw = dict(max_iter=3, rhos=0.2, lams=0.05, params=s["params"])
    full = solver.solve(x0=real_x0, **kw)
    assert full.dtype == torch.complex64
    real = solver.solve(x0=real_x0, real_output=True, **kw)
    assert real.dtype == torch.float32 and torch.equal(real, full.real)
    # lam stays real under a complex state
    out = dp.deep_prior(x, "tv").prox(full, torch.tensor(0.05 + 0j, dtype=torch.complex64))
    assert not out.is_complex()


def test_nonneg_block_on_a_complex_state_raises():
    """torch orders no complex numbers: a nonneg or norm1 block on a
    complex state raises, naming why, and takes no generic route."""
    s = csmri.generate_sample(size=16, num_lines=6)
    for block in (dp.nonneg, dp.norm1):
        x = dp.Variable()
        solver = dp.compile([dp.csmri(x, dp.Placeholder("mask", batch=False),
                                      dp.Placeholder("y")), block(x)],
                            method="admm", device="cpu")
        with pytest.raises(NotImplementedError, match="no order on complex"):
            solver.solve(x0=s["x0"], max_iter=1, rhos=0.2, lams=0.05, params=s["params"])


def test_mat_round_trip_loads_and_solves(tmp_path):
    """tests/test_optics.py::test_csmri_mat_roundtrip: the reference's
    .mat evaluation format, loaded by both packages to the same arrays,
    and solved."""
    from scipy.io import savemat

    s = csmri.generate_sample(size=32, num_lines=12)
    x0, y0 = s["x0"][0], s["params"]["y"][0]

    def r2pair(z):
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)

    path = str(tmp_path / "sample.mat")
    savemat(path, {"name": "synthetic", "x0": r2pair(x0), "y0": r2pair(y0), "ATy0": r2pair(x0),
                   "sigma_n": r2pair(np.zeros((1,), np.complex64)),
                   "mask": s["mask"][0, 0].astype(np.float64), "gt": s["gt"][0, 0]})
    mat, ref = csmri.load_data(path), jcsmri.load_data(path)
    assert mat["name"] == ref["name"] == "synthetic"
    for k in ("x0", "y0", "input", "output", "mask", "sigma_n"):
        assert np.array_equal(mat[k], ref[k]), k
    assert np.iscomplexobj(mat["x0"]) and mat["mask"].dtype == bool
    x = dp.Variable()
    solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                        + dp.deep_prior(x, "tv", sqrt=True), method="admm", device="cpu")
    rhos, sigmas = dp.log_descent(30, 5, 8, sigma=0.01)
    out = solver.solve(x0=mat["x0"][None], rhos=rhos, lams=sigmas, max_iter=8,
                       params={"y": mat["y0"][None], "mask": mat["mask"]}, real_output=True)
    assert bool(torch.isfinite(out).all())


def test_dataset_sample_and_policy_observation_match_jax():
    ds, jds = csmri.CSMRIDataset(size=16, num_samples=3), jcsmri.CSMRIDataset(size=16, num_samples=3)
    assert len(ds) == 3 and np.array_equal(ds[4]["y0"], jds[4]["y0"])
    # offline, without the reference's assets, both give the phantom
    assert csmri.sample_reference() is None
    got, ref = csmri.sample(size=32), jcsmri.sample(size=32)
    assert np.array_equal(got["gt"], ref["gt"]) and np.array_equal(got["y0"], ref["y0"])
    s = csmri.generate_sample(size=16, num_lines=6)
    aux = {"y0": s["y0"], "mask": s["mask"], "sigma_n": np.full((1, 1, 16, 16), 0.1, np.float32)}
    variables = np.random.RandomState(0).rand(1, 3, 16, 16).astype(np.float32)
    T = np.full((1, 1, 16, 16), 0.5, np.float32)
    x0 = np.real(s["x0"]).astype(np.float32)
    got = csmri.custom_policy_ob_pack_fn(variables, x0, T, aux)
    ref = jcsmri.custom_policy_ob_pack_fn(variables, x0, T, aux)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(csmri.complex2channel(s["x0"]).numpy(),
                          np.asarray(jcsmri.complex2channel(jnp.asarray(s["x0"]))))

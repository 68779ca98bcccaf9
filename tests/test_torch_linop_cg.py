"""mosaic / grad / mul_elementwise / Placeholder, the Bayer utilities and
the CG and spatial-diagonal x-updates of the port against the JAX package.

Operators are the same float32 arithmetic (FFT-based ones differ by FFT
rounding): atol 1e-6 on O(1) data. The x-updates are iterative float32
solves of the same system on the same b, rho, v: atol 1e-4.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu_torch.utils import imaging

SHAPE = (2, 3, 16, 20)
RNG = np.random.RandomState(0)
X = RNG.rand(*SHAPE).astype(np.float32)
Y = RNG.rand(*SHAPE).astype(np.float32)
WEIGHT = RNG.rand(1, 3, 16, 20).astype(np.float32)
PSF = imaging.point_spread_function(5, 1.5)


def _ops(pkg, arr):
    """name -> (operator on a fresh Variable, params)"""
    return {
        "mosaic": (pkg.mosaic(pkg.Variable()), None),
        "grad0": (pkg.grad(pkg.Variable(), dim=0), None),
        "grad1": (pkg.grad(pkg.Variable(), dim=1), None),
        "grad2": (pkg.grad(pkg.Variable(), dim=2), None),
        "mul": (pkg.mul_elementwise(pkg.Variable(), WEIGHT), None),
        "mul_ph": (pkg.mul_elementwise(pkg.Variable(), pkg.Placeholder("w")), {"w": arr(WEIGHT)}),
        "mosaic_conv": (pkg.mosaic(pkg.conv(pkg.Variable(), PSF)), None),
        "scaled_grad": (2.0 * pkg.grad(pkg.Variable(), dim=1), None),
    }


OP_NAMES = list(_ops(dp, torch.from_numpy))


@pytest.mark.parametrize("name", OP_NAMES)
def test_operator_matches_jax(name):
    op_t, par_t = _ops(dp, torch.from_numpy)[name]
    op_j, par_j = _ops(jdp, jnp.asarray)[name]
    vt, vj = op_t.variables[0].name, op_j.variables[0].name
    fwd = op_t.forward({vt: torch.from_numpy(X)}, par_t)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(op_j.forward({vj: jnp.asarray(X)}, par_j)),
                               rtol=0, atol=1e-6)
    adj = op_t.adjoint(torch.from_numpy(Y), par_t)[vt]
    np.testing.assert_allclose(adj.numpy(), np.asarray(op_j.adjoint(jnp.asarray(Y), par_j)[vj]),
                               rtol=0, atol=1e-6)
    # <K x, y> == <x, K^T y>
    assert abs(float((fwd * torch.from_numpy(Y)).sum() - (torch.from_numpy(X) * adj).sum())) < 1e-3
    for freq in (False, True):
        assert op_t.is_diag(freq) == op_j.is_diag(freq)
        assert op_t.is_gram_diag(freq) == op_j.is_gram_diag(freq)
        if op_t.is_gram_diag(freq):
            np.testing.assert_allclose(
                torch.as_tensor(op_t.gram_diag(SHAPE, par_t, freq)).numpy(),
                np.asarray(op_j.gram_diag(SHAPE, par_j, freq)), rtol=0, atol=1e-6)
    s_t, s_j = op_t.gram_freq_surrogate(SHAPE, par_t), op_j.gram_freq_surrogate(SHAPE, par_j)
    np.testing.assert_allclose(torch.as_tensor(s_t).numpy(), np.asarray(s_j), rtol=0, atol=1e-6)


def test_placeholder_and_surrogate_structure():
    ph = dp.Placeholder("b")
    with pytest.raises(KeyError, match="'b'"):
        ph.value({})
    val = ph.forward({}, {"b": X[0].transpose(1, 2, 0)})  # HWC numpy -> BCHW tensor
    assert val.shape == (1, 3, 16, 20)
    assert float(ph.forward({}, {"b": X}, zero_constants=True).abs().max()) == 0.0
    assert ph.adjoint(torch.from_numpy(Y), {"b": X}) == {}
    assert ph.is_diag() and ph.constants == [ph] and float(ph.diag(SHAPE)) == 0.0
    x = dp.Variable()
    # an offset does not change the surrogate; two variable branches have none
    np.testing.assert_array_equal(
        (dp.mosaic(x) - ph).gram_freq_surrogate(SHAPE, {"b": X}).numpy(),
        dp.mosaic(x).gram_freq_surrogate(SHAPE).numpy())
    assert (dp.mosaic(x) + dp.grad(x)).gram_freq_surrogate(SHAPE) is None
    stack_t = dp.vstack([dp.mosaic(dp.conv(x, PSF)), 3.0 * x])
    xj = jdp.Variable()
    stack_j = jdp.vstack([jdp.mosaic(jdp.conv(xj, PSF)), 3.0 * xj])
    np.testing.assert_allclose(stack_t.gram_freq_surrogate(SHAPE).numpy(),
                               np.asarray(stack_j.gram_freq_surrogate(SHAPE)), rtol=0, atol=1e-6)


def test_bayer_utilities_match_jax():
    np.testing.assert_array_equal(imaging.bayer_mask((6, 8)), jimaging.bayer_mask((6, 8)))
    m_t = imaging.mosaicing(torch.from_numpy(X))
    m_j = jimaging.mosaicing(jnp.asarray(X))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(dp.utils.demosaic_from_mosaiced(m_t).numpy(),
                               np.asarray(jdp.utils.demosaic_from_mosaiced(m_j)),
                               rtol=0, atol=1e-6)
    planes = RNG.rand(2, 4, 5, 7).astype(np.float32)
    np.testing.assert_allclose(dp.utils.demosaic_bilinear(torch.from_numpy(planes)).numpy(),
                               np.asarray(jdp.utils.demosaic_bilinear(jnp.asarray(planes))),
                               rtol=0, atol=1e-6)


def _record_solver_calls(monkeypatch):
    """Wraps every entry of the port's SOLVERS and the structured CG of
    mosaic(conv(x)) (linalg/structured.py); returns a list that gets one
    [name, inner iterations] per solver call. cg, pcg and cg_pallas apply A
    once in their set-up and once per iteration; the structured solve's
    iterations are its count in ``linalg.iterations``."""
    import importlib

    from dprox_tpu_torch.linalg import solve as solve_module
    from dprox_tpu_torch.utils import profiling

    ss_module = importlib.import_module("dprox_tpu_torch.proxfn.sum_squares")
    called = []
    structured = ss_module.mosaic_conv_pcg

    def structured_solve(*args, **kw):
        before = profiling.counts().get("linalg.iterations", 0)
        x = structured(*args, **kw)
        called.append(["mosaic_conv_pcg", profiling.counts()["linalg.iterations"] - before])
        return x

    monkeypatch.setattr(ss_module, "mosaic_conv_pcg", structured_solve)

    def wrap(name, fn):
        def solver(A, b, **kw):
            called.append([name, -1])

            def counted(v, _entry=called[-1]):
                _entry[1] += 1
                return A(v)

            return fn(counted, b, **kw)
        return solver

    for name, fn in list(solve_module.SOLVERS.items()):
        monkeypatch.setitem(solve_module.SOLVERS, name, wrap(name, fn))
    return called


def _joint(pkg, arr, cfg):
    x = pkg.Variable()
    data = pkg.sum_squares(pkg.mosaic(pkg.conv(x, PSF)) - pkg.Placeholder("b"))
    solver = pkg.compile(data + pkg.deep_prior(x, "tv"), "admm", linear_solve_config=cfg,
                         **({"device": "cpu"} if pkg is dp else {}))
    return solver.least_square


@pytest.mark.parametrize("solver_type,runs", [("cg", "mosaic_conv_pcg"),
                                               ("cg_pallas", "cg_pallas")])
def test_solve_cg_matches_jax(solver_type, runs, monkeypatch):
    """One CG x-update of the joint demosaic + deconvolution problem:
    ``cg`` is upgraded to pcg with the frequency-Jacobi preconditioner, which
    this operator runs as the structured ``mosaic_conv_pcg``; ``cg_pallas``
    runs unpreconditioned through the fused tail."""
    called = _record_solver_calls(monkeypatch)
    b = np.array(jimaging.mosaicing(jimaging.blurring(jnp.asarray(X), PSF)))
    v = RNG.rand(*SHAPE).astype(np.float32)
    warm = RNG.rand(*SHAPE).astype(np.float32)
    rho = np.array([0.3, 0.05], np.float32)
    ls_t = _joint(dp, torch.from_numpy, dp.LinearSolveConfig(max_iters=40, solver_type=solver_type))
    ls_j = _joint(jdp, jnp.asarray, jdp.LinearSolveConfig(max_iters=40, solver_type=solver_type))
    assert repr(ls_t) == repr(ls_j) == ("least_squares(diagonalizable=False, "
                                        "freq_diagonalizable=False)")
    shapes_t = {n: SHAPE for n in ls_t._var_shapes(torch.from_numpy(v))}
    shapes_j = {n: SHAPE for n in ls_j._var_shapes(jnp.asarray(v))}
    prep_t = ls_t.prepare(shapes_t, {"b": torch.from_numpy(b)}, ref_shape=SHAPE)
    prep_j = ls_j.prepare(shapes_j, {"b": jnp.asarray(b)}, ref_shape=SHAPE)
    assert set(prep_t) == set(prep_j) == {"Ktb_quad", "precond_quad", "precond_psi"}
    np.testing.assert_allclose(prep_t["precond_quad"].numpy(), np.asarray(prep_j["precond_quad"]),
                               rtol=0, atol=1e-6)
    for prepared_t, prepared_j in ((prep_t, prep_j), (None, None)):
        got = ls_t.solve([torch.from_numpy(v)], torch.from_numpy(rho),
                         params={"b": torch.from_numpy(b)}, var_shapes=shapes_t,
                         prepared=prepared_t, warm=torch.from_numpy(warm))
        ref = ls_j.solve([jnp.asarray(v)], jnp.asarray(rho), params={"b": jnp.asarray(b)},
                         var_shapes=shapes_j, prepared=prepared_j, warm=jnp.asarray(warm))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    assert [name for name, _ in called] == [runs, runs]
    assert all(0 < inner <= 40 for _, inner in called)


def test_spatial_diagonal_solve_direct_matches_jax():
    """Demosaic: K^T K = mask + rho is diagonal in space; the x-update is
    ``K^T b / (diag + eps)``."""
    b = np.array(jimaging.mosaicing(jnp.asarray(X)))
    v = RNG.rand(*SHAPE).astype(np.float32)
    rho = np.array([0.3, 0.05], np.float32)

    def build(pkg, arr):
        x = pkg.Variable()
        fns = [pkg.sum_squares(pkg.mosaic(x), b=arr(b)), pkg.deep_prior(x, "tv")]
        return pkg.compile(fns, "admm", **({"device": "cpu"} if pkg is dp else {})).least_square

    ls_t, ls_j = build(dp, torch.from_numpy), build(jdp, jnp.asarray)
    assert repr(ls_t) == repr(ls_j) == ("least_squares(diagonalizable=True, "
                                        "freq_diagonalizable=False)")
    for with_prepared in (True, False):
        prep_t = ls_t.prepare({"x": SHAPE}, None, ref_shape=SHAPE) if with_prepared else None
        prep_j = ls_j.prepare({"x": SHAPE}, None, ref_shape=SHAPE) if with_prepared else None
        got = ls_t.solve([torch.from_numpy(v)], torch.from_numpy(rho), prepared=prep_t)
        ref = ls_j.solve([jnp.asarray(v)], jnp.asarray(rho), prepared=prep_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    # the prox form (no psi blocks, + rho v) goes through the same engine
    ls_t = dp.least_squares([dp.sum_squares(dp.mosaic(dp.Variable()), b=torch.from_numpy(b))], [])
    ls_j = jdp.least_squares([jdp.sum_squares(jdp.mosaic(jdp.Variable()), b=jnp.asarray(b))], [])
    got = ls_t.prox(torch.from_numpy(v), torch.from_numpy(rho))
    ref = ls_j.prox(jnp.asarray(v), jnp.asarray(rho))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_try_diagonalize_flags_route_a_diagonal_problem_to_cg(monkeypatch):
    """With try_diagonalize=False the deconvolution x-update runs CG and
    agrees with the frequency-diagonal solve to the CG tolerance."""
    called = _record_solver_calls(monkeypatch)
    b = np.array(jimaging.blurring(jnp.asarray(X), PSF))
    v = RNG.rand(*SHAPE).astype(np.float32)
    outs = {}
    for flag in (True, False):
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, PSF) - torch.from_numpy(b)),
                             dp.deep_prior(x, "tv")], "admm", device="cpu",
                            try_diagonalize=flag,
                            linear_solve_config=dp.LinearSolveConfig(rtol=1e-7, max_iters=200))
        ls = solver.least_square
        assert ls.freq_diagonalizable == flag
        aux = solver.prepare_aux(torch.from_numpy(b), {})
        outs[flag] = ls.solve([torch.from_numpy(v)], 0.2, prepared=aux.lsq)
    assert [name for name, _ in called] == ["pcg"] and called[0][1] > 0
    np.testing.assert_allclose(outs[False].numpy(), outs[True].numpy(), rtol=0, atol=1e-4)

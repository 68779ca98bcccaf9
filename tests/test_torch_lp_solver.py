"""The port's LP ADMM solver against the JAX package and scipy HiGHS, on
the CPU.

Both packages run on the same equilibrated operator (the JAX BSRMat's
arrays through ``bsr_from_numpy``) and the same hyperparameters
(``lp_params_from_numpy``). Tolerances: float64 trajectories agree to
1e-9 relative (the two PCGs stop on the same test, sums ordered
differently); float32 to 1e-4 relative; the truncated solve's loss and
its five gradients to 1e-6 relative in float64; solves against HiGHS at
the tolerances of tests/test_lp.py.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog
import jax
import jax.numpy as jnp

from dprox_tpu.algo import lp as jlp
from dprox_tpu.linalg import solvers as jsolvers
from dprox_tpu_torch.algo import lp
from dprox_tpu_torch.algo.lp.solvers import pretrain_lp
from dprox_tpu_torch.contrib.energy_system import synthetic_cep_model
from dprox_tpu_torch.linalg import solvers

ARRAYS = ("tiles", "row_ids", "col_ids", "tilesT", "row_idsT", "col_idsT")
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(autouse=True, scope="module")
def enable_x64():
    """float64 in JAX for this module, as tests/test_lp.py; and one torch
    thread: these loops are thousands of tiny ops, which several test
    workers with a thread pool each only slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(threads)


def small_lp(seed=0, n=20, with_ub=True):
    rng = np.random.RandomState(seed)
    c = rng.rand(n) + 0.1
    A_ub = sp.csr_matrix(rng.rand(10, n)) if with_ub else None
    b_ub = A_ub @ rng.rand(n) + 0.5 if with_ub else None
    A_eq = sp.csr_matrix(rng.rand(3, n))
    b_eq = A_eq @ rng.rand(n)
    return c, A_ub, b_ub, A_eq, b_eq


def cep(n_periods=16, n_tech=4):
    c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(n_periods, n_tech)
    return c, A_ub, b_ub, A_eq, b_eq


def highs(c, A_ub, b_ub, A_eq, b_eq):
    ref = linprog(c, None if A_ub is None else A_ub.toarray(), b_ub, A_eq.toarray(), b_eq,
                  bounds=[(0, None)] * c.shape[0], method="highs")
    assert ref.success
    return ref


def problem_pair(data, dtype):
    """The JAX problem and the port's, the latter on the former's operator."""
    jp = jlp.LPProblem(*data, dtype=JDT[dtype])
    p = lp.LPProblem(*data, dtype=dtype, device="cpu")
    op = lp.bsr_from_numpy([np.asarray(getattr(jp.A, n)) for n in ARRAYS], jp.A.shape,
                           device="cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(op, name), getattr(p.A, name)), name
    p.A, p.AT = op, op.T
    for name in ("d", "e", "Acnorm", "c", "lb", "ub"):
        assert np.array_equal(getattr(p, name).numpy(), np.asarray(getattr(jp, name))), name
    assert (p.gamma_c, p.gamma_b) == (jp.gamma_c, jp.gamma_b)
    return jp, p


def solver_pair(dtype, **kw):
    js = jlp.LPSolverADMM(dtype=JDT[dtype], verbose=False, **kw)
    s = lp.LPSolverADMM(dtype=dtype, verbose=False, **kw)
    jparams = js.init_params()
    params = lp.lp_params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                     device="cpu")
    assert all(v.dtype == dtype and v.ndim == 0 for v in params.values())
    assert {k: float(v) for k, v in params.items()} == \
        {k: float(v) for k, v in s.init_params().items()}
    return js, s, jparams, params


def _system(seed=0, n=12, batch=2):
    rng = np.random.RandomState(seed)
    P = rng.rand(n, n)
    return P @ P.T + n * np.eye(n), rng.rand(batch, n)


@pytest.mark.parametrize("max_iters", [3, 30])
def test_cg_unrolled_value_and_gradient_match_jax(max_iters):
    """float64; 3 iterations stop short of convergence, 30 run on with
    converged batch elements frozen (the masks must pass no NaN back).
    Value 1e-10, gradients wrt b and a scale of A 1e-8 relative."""
    M, b0 = _system()
    Mt, Mj = torch.as_tensor(M), jnp.asarray(M)

    def loss_t(b, s):
        x = solvers.cg_unrolled(lambda v: s * (v @ Mt.T), b, rtol=1e-9, max_iters=max_iters)
        return torch.sum(x ** 2), x

    def loss_j(b, s):
        x = jsolvers.cg_unrolled(lambda v: s * (v @ Mj.T), b, rtol=1e-9, max_iters=max_iters)
        return jnp.sum(x ** 2), x

    b, s = torch.as_tensor(b0).requires_grad_(), torch.tensor(1.3, dtype=torch.float64,
                                                              requires_grad=True)
    val, x = loss_t(b, s)
    gb, gs = torch.autograd.grad(val, (b, s))
    (jval, jx), (jgb, jgs) = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        jnp.asarray(b0), jnp.asarray(1.3))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(float(gs), float(jgs), rtol=1e-8)
    assert bool(torch.isfinite(gb).all()) and np.isfinite(float(gs))
    if max_iters == 30:  # converged: x = (s M)^-1 b
        np.testing.assert_allclose(x.detach().numpy(), np.linalg.solve(1.3 * M, b0.T).T,
                                   rtol=1e-8)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_one_iter_x25_and_eval_result_match_jax(dtype, tol):
    jp, p = problem_pair(cep(), dtype)
    js, s, jparams, params = solver_pair(dtype)
    jc, jlb, jub, jgc, jgb = js._prepare(jp, jparams)
    c, lb, ub, gc, gb = s._prepare(p, params)
    for got, ref in ((c, jc), (lb, jlb), (ub, jub)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6 if dtype == torch.float32 else 1e-15)
    rtols = np.maximum(np.logspace(-6, -10, 10000), 50 * float(jnp.finfo(JDT[dtype]).eps))[:25]
    jrho, jsigma, jalpha = jparams["rho"], jnp.exp(jparams["sigma_log"]), jparams["alpha"]

    @jax.jit
    def jrun(carry, rt):
        step = lambda cr, r: (js._one_iter(jp, cr, r, jrho, jc, jsigma, jalpha, jlb, jub, 1000), None)
        return jax.lax.scan(step, carry, rt)[0]

    m, n = jp.problem_scale
    z = lambda k: jnp.zeros(k, JDT[dtype])
    jcarry = jrun((z(n), z(m), z(m), z(n)), jnp.asarray(rtols, JDT[dtype]))
    carry = s._zero_carry(p)
    rt = torch.as_tensor(rtols).to(dtype)
    with torch.no_grad():
        for i in range(25):
            carry = s._one_iter(p, carry, rt[i], params["rho"], c,
                                torch.exp(params["sigma_log"]), params["alpha"], lb, ub, 1000)
    for got, ref, name in zip(carry, jcarry, "x z y xtilde".split()):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max(), name
    jres = js.eval_result(jp, jc, jgc, jgb, *jcarry[:3])
    res = s.eval_result(p, c, gc, gb, *carry[:3])
    np.testing.assert_allclose([float(v) for v in res], [float(v) for v in jres], rtol=tol * 10)


def test_prepare_keeps_infinite_bounds_and_finite_gradients():
    _, p = problem_pair(small_lp(5), torch.float64)
    s = lp.LPSolverADMM(verbose=False)
    params = {k: v.requires_grad_() for k, v in s.init_params().items()}
    c, lb, ub, _, _ = s._prepare(p, params)
    assert bool(torch.isinf(lb[:p.m_ub]).all()) and bool(torch.isinf(ub[-p.n:]).all())
    (c.sum() + lb[p.m_ub:].sum() + ub[:-p.n].sum()).backward()
    assert all(v.grad is None or bool(torch.isfinite(v.grad)) for v in params.values())
    assert float(params["gamma_b_mul"].grad) != 0.0 and float(params["gamma_c_mul"].grad) != 0.0


def test_solve_truncated_loss_and_five_gradients_match_jax():
    jp, p = problem_pair(cep(), torch.float64)
    js, s, jparams, params = solver_pair(torch.float64)
    jloss_fn, loss_fn = jlp.LPConvergenceLoss(), lp.LPConvergenceLoss()
    jval, jgrads = jax.value_and_grad(
        lambda pp: jloss_fn(*js.solve_truncated(jp, pp, iters=10)))(jparams)
    params = {k: v.requires_grad_() for k, v in params.items()}
    val = loss_fn(*s.solve_truncated(p, params, iters=10))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-8)
    for k in jparams:
        g = float(params[k].grad)
        assert np.isfinite(g) and g != 0.0, k
        np.testing.assert_allclose(g, float(jgrads[k]), rtol=1e-6, err_msg=k)


def test_pretraining_follows_jax_adam_and_keeps_the_best():
    """Adam parity: three steps of the port's pretraining give the losses
    of three optax.adam steps on the JAX solver (1e-6 relative), and the
    parameters returned are those with the lowest loss seen."""
    import optax

    jp, p = problem_pair(cep(), torch.float64)
    js, s, jparams, _ = solver_pair(torch.float64)
    jloss_fn = jlp.LPConvergenceLoss()
    tx = optax.adam(1e-2)
    state, jlosses, seen = tx.init(jparams), [], []
    bounds = {"rho": (1e-6, 1e6), "alpha": (0.1, 1.95), "sigma_log": (-30.0, 5.0),
              "gamma_c_mul": (1e-3, 1e3), "gamma_b_mul": (1e-3, 1e3)}
    for _ in range(3):
        seen.append(jparams)
        val, g = jax.value_and_grad(
            lambda pp: jloss_fn(*js.solve_truncated(jp, pp, iters=10)))(jparams)
        upd, state = tx.update(g, state)
        jparams = optax.apply_updates(jparams, upd)
        jparams = {k: jnp.clip(v, *bounds[k]) for k, v in jparams.items()}
        jlosses.append(float(val))
    best, log = pretrain_lp(s, p, steps=3, lr=1e-2)
    np.testing.assert_allclose([e["loss"] for e in log], jlosses, rtol=1e-6)
    ref = seen[int(np.argmin(jlosses))]
    for k, v in best.items():
        assert not v.requires_grad
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=1e-6, err_msg=k)


def test_fused_solve_matches_chunked():
    data = small_lp(2)
    p = lp.LPProblem(*data, device="cpu")
    s = lp.LPSolverADMM(verbose=False)
    x1, hist, res1 = s.solve(p, max_iters=5000, residual_balance=True)
    x2, res2 = s.solve_fused(p, max_iters=5000)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-4)
    assert res2["r_norm"] < res2["eps_primal"] and res2["s_norm"] < res2["eps_dual"]
    assert 0 < res2["iters"] <= 5000 and res2["iters"] == 25 * len(hist["t_chunk"])
    assert set(res2) == {"objective", "r_norm", "s_norm", "eps_primal", "eps_dual", "iters",
                         "wall_s_incl_first_compile"}
    np.testing.assert_allclose(list(res1), [res2[k] for k in ("objective", "r_norm", "s_norm",
                                                               "eps_primal", "eps_dual")],
                               rtol=1e-9)
    # and both agree with the JAX package's fused solve on the same problem
    # (thousands of iterations whose PCGs stop at the same test on sums
    # ordered differently: same count, x to 1e-5)
    jx, jres = jlp.LPSolverADMM(verbose=False).solve_fused(jlp.LPProblem(*data), max_iters=5000)
    assert jres["iters"] == res2["iters"]
    np.testing.assert_allclose(x2.numpy(), np.asarray(jx), atol=1e-5)


def test_fused_solve_respects_max_iters():
    c, _, _, A_eq, b_eq = small_lp(7, n=15, with_ub=False)
    p = lp.LPProblem(c, None, None, A_eq, b_eq, device="cpu")
    s = lp.LPSolverADMM(verbose=False, abstol=1e-12, reltol=1e-12)
    # unreachable tolerance: the loop must stop at exactly max_iters even
    # when eval_freq does not divide it
    x, res = s.solve_fused(p, max_iters=57, eval_freq=25)
    assert res["iters"] == 57
    _, hist, _ = s.solve(p, max_iters=57, eval_freq=25)
    assert len(hist["t_chunk"]) == 3 and len(hist["objval"]) == 3


def test_fused_rho_balance_fires_when_a_multiple_of_1000_is_crossed():
    """eval_freq 300 never lands on 1000; the chunk 900 -> 1200 crosses it
    and rebalances rho for the iterations that follow."""
    data = small_lp(2)
    p = lp.LPProblem(*data, device="cpu")
    s = lp.LPSolverADMM(verbose=False, abstol=1e-9, reltol=1e-9)
    x_off, _ = s.solve_fused(p, max_iters=1500, eval_freq=300, residual_balance=False)
    x_on, _ = s.solve_fused(p, max_iters=1500, eval_freq=300)
    x_early, _ = s.solve_fused(p, max_iters=900, eval_freq=300)
    x_early_off, _ = s.solve_fused(p, max_iters=900, eval_freq=300, residual_balance=False)
    assert torch.equal(x_early, x_early_off)
    assert not torch.equal(x_on, x_off)


def test_fused_solve_float32_and_polish():
    data = small_lp(4)
    c, A_ub, b_ub, A_eq, b_eq = data
    ref = highs(*data)
    p = lp.LPProblem(*data, dtype=torch.float32, device="cpu")
    s = lp.LPSolverADMM(dtype=torch.float32, verbose=False)
    x, res = s.solve_fused(p, max_iters=8000)
    assert x.dtype == torch.float32
    obj = float(np.dot(c, x.double().numpy()))
    assert abs(obj - ref.fun) / max(abs(ref.fun), 1) < 5e-2
    assert float(np.abs(A_eq @ x.double().numpy() - b_eq).max()) < 5e-2
    xp, resp = s.solve_fused(p, max_iters=8000, polish=True)
    objp = float(np.dot(c, xp.double().numpy()))
    assert abs(objp - ref.fun) / max(abs(ref.fun), 1) <= abs(obj - ref.fun) / max(abs(ref.fun), 1) + 1e-6


@pytest.mark.parametrize("instance", ["random20", "cep_16_4"])
def test_solve_lp_matches_highs(instance):
    if instance == "random20":
        data, iters, denom = small_lp(0), 5000, lambda f: max(abs(f), 1)
    else:
        data, iters, denom = cep(), 8000, abs
    c, A_ub, b_ub, A_eq, b_eq = data
    ref = highs(*data)
    x, history, results = lp.solve_lp(c, A_ub, b_ub, A_eq, b_eq, max_iters=iters,
                                      pretrain_steps=5, verbose=False, dtype=torch.float64,
                                      device="cpu")
    x = x.numpy()
    assert abs(float(np.dot(c, x)) - ref.fun) / denom(ref.fun) < 5e-2
    if instance == "random20":  # feasibility, as tests/test_lp.py holds it
        assert float((A_ub @ x - b_ub).max()) < 1e-2
        assert float(np.abs(A_eq @ x - b_eq).max()) < 1e-2
        assert float(x.min()) > -1e-2
    assert len(history["r_norm"]) == len(history["t_chunk"]) > 0 and len(results) == 5


def test_solve_lp_default_dtype_and_fused_route():
    c, A_ub, b_ub, A_eq, b_eq = small_lp(0)
    x, history, results = lp.solve_lp(c, A_ub, b_ub, A_eq, b_eq, max_iters=200,
                                      pretrain_steps=0, verbose=False, fused=True,
                                      device="cpu")
    assert x.dtype == torch.get_default_dtype() and history == {}
    assert results["iters"] == 200 or results["r_norm"] < results["eps_primal"]


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c, A_ub, b_ub, A_eq, b_eq = small_lp(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lp.LPProblem(c, A_ub, b_ub, A_eq, b_eq)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lp.solve_lp(c, A_ub, b_ub, A_eq, b_eq, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lp.BSRMat(A_ub)

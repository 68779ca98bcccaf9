"""The port's single-device scenario-consensus LP solver against the JAX
package and the HiGHS extensive form, on the CPU.

Same instances (``synthetic_cep_scenarios``, numpy seeds) through
dprox_tpu.algo.lp.consensus and its port. Tolerances: a fixed number of
float64 outer iterations agrees with the JAX solver to 1e-7 (batched PCG
stopping on the same test, sums ordered differently); objective against
HiGHS and the consensus capacities at the tolerances of tests/test_lp.py.
"""
import numpy as np
import pytest
import torch
from scipy.optimize import linprog
import jax
import jax.numpy as jnp

from dprox_tpu.algo import lp as jlp
from dprox_tpu_torch.algo import lp
from dprox_tpu_torch.contrib.energy_system import extensive_form, synthetic_cep_scenarios


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


def instance(S=4):
    return synthetic_cep_scenarios(16, 4, S)


def scenario_lp(inst, **kw):
    c, A_ub, A_eq, b_ub, b_eq_s, sh = inst
    return lp.ScenarioLP(c, A_ub, b_ub, A_eq, b_eq_s, sh, device="cpu", **kw)


def test_matches_extensive_form():
    c, A_ub, A_eq, b_ub, b_eq_s, sh = instance()
    cf, Auf, Aef, buf, bef = extensive_form(c, A_ub, A_eq, b_ub, b_eq_s, sh)
    ref = linprog(cf, Auf, buf, Aef, bef, bounds=(0, None), method="highs")
    z, xs, hist, res = lp.solve_consensus_lp(
        c, A_ub, b_ub, A_eq, b_eq_s, sh, max_outer=300, eval_freq=100, tol=1e-3,
        rho_ph=1.0, verbose=False, dtype=torch.float64, device="cpu")
    assert abs(res["objective"] - ref.fun) / abs(ref.fun) < 2e-3
    # consensus capacity close to the extensive-form first stage
    assert np.abs(z - ref.x[:4]).max() < 1.0
    assert res["r_nonanticipativity"] < 5e-2
    assert xs.shape == (4, c.shape[0]) and len(hist["objective"]) == len(hist["t_chunk"])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-7), (torch.float32, 2e-3)])
def test_fixed_iterations_match_jax_solver(dtype, tol):
    """40 outer iterations without adaptation or early stop, both packages
    from the same defaults (``lp_params_from_numpy``)."""
    inst = instance()
    c, A_ub, A_eq, b_ub, b_eq_s, sh = inst
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    kw = dict(max_outer=40, eval_freq=20, tol=0, adapt_rho_ph=False, pcg_rtol=1e-9)
    jsolver = jlp.ConsensusLPSolver(dtype=jdt)
    jp = jlp.ScenarioLP(c, A_ub, b_ub, A_eq, b_eq_s, sh, dtype=jdt)
    jz, jxs, _, jres = jsolver.solve(jp, **kw)
    p = scenario_lp(inst, dtype=dtype)
    for name in ("lb", "ub", "d", "Acnorm", "c", "pn", "w"):
        assert np.array_equal(getattr(p, name).numpy(), np.asarray(getattr(jp, name))), name
    params = lp.lp_params_from_numpy(
        {k: np.asarray(v) for k, v in jsolver.init_params().items()}, device="cpu")
    assert set(params) == {"rho", "sigma", "alpha", "rho_ph"}
    z, xs, _, res = lp.ConsensusLPSolver(dtype=dtype).solve(p, params=params, **kw)
    scale = np.abs(jxs).max()
    assert np.abs(z - jz).max() <= tol * scale and np.abs(xs - jxs).max() <= tol * scale
    np.testing.assert_allclose(res["objective"], jres["objective"], rtol=tol)
    assert res["outer_iters"] == jres["outer_iters"] == 40


def test_f32_runs():
    c, A_ub, A_eq, b_ub, b_eq_s, sh = instance()
    z, xs, hist, res = lp.solve_consensus_lp(
        c, A_ub, b_ub, A_eq, b_eq_s, sh, dtype=torch.float32, max_outer=60, eval_freq=30,
        tol=0, rho_ph=1.0, pcg_rtol=1e-6, device="cpu")
    assert np.isfinite(res["objective"]) and xs.dtype == np.float32
    assert res["r_nonanticipativity"] < 10.0


def test_probs_weighting_matches_duplication():
    """probs=[2,1,1]/4 on 3 scenarios == uniform over 4 scenarios with the
    first duplicated."""
    c, A_ub, A_eq, b_ub, b_eq_s, sh = instance(S=4)
    b3 = b_eq_s[1:]
    b4 = np.concatenate([b3[:1], b3], axis=0)
    kw = dict(max_outer=60, eval_freq=30, tol=0, adapt_rho_ph=False)
    s = lp.ConsensusLPSolver()
    pw = scenario_lp((c, A_ub, A_eq, b_ub, b3, sh), probs=np.array([2.0, 1.0, 1.0]))
    pd = scenario_lp((c, A_ub, A_eq, b_ub, b4, sh))
    zw, _, _, rw = s.solve(pw, **kw)
    zd, _, _, rd = s.solve(pd, **kw)
    np.testing.assert_allclose(zw, zd, atol=1e-8)
    np.testing.assert_allclose(rw["objective"], rd["objective"], rtol=1e-9)
    with pytest.raises(ValueError, match="positive weights"):
        scenario_lp((c, A_ub, A_eq, b_ub, b3, sh), probs=np.array([1.0, -1.0, 1.0]))


def test_fused_clamps_non_divisible_eval_freq():
    p = scenario_lp(instance(S=4))
    s = lp.ConsensusLPSolver()
    kw = dict(max_outer=57, eval_freq=25, tol=0, adapt_rho_ph=False)
    z1, _, _, r1 = s.solve(p, **kw)
    z2, _, r2 = s.solve_fused(p, **kw)
    assert r2["outer_iters"] == 57 == r1["outer_iters"]
    np.testing.assert_allclose(z1, z2, atol=1e-10)


def test_fused_matches_chunked_with_rho_ph_adaptation():
    p = scenario_lp(synthetic_cep_scenarios(16, 4, 8))
    s = lp.ConsensusLPSolver()
    kw = dict(max_outer=80, eval_freq=40, tol=1e-3)
    z1, x1, _, r1 = s.solve(p, **kw)
    z2, x2, r2 = s.solve_fused(p, **kw)
    np.testing.assert_allclose(z1, z2, atol=1e-9)
    assert r1["rho_ph_final"] == r2["rho_ph_final"]
    assert set(r2) == set(r1) == {"objective", "r_nonanticipativity", "r_primal",
                                  "outer_iters", "rho_ph_final"}


def test_solve_truncated_matches_jax_value_and_gradients():
    """float64, loss log(r_na) + log(r_p): value 1e-8, the four gradients
    1e-5 relative (max-type residuals, same active element)."""
    inst = instance()
    c, A_ub, A_eq, b_ub, b_eq_s, sh = inst
    jsolver, solver = jlp.ConsensusLPSolver(), lp.ConsensusLPSolver()
    jp, p = jlp.ScenarioLP(c, A_ub, b_ub, A_eq, b_eq_s, sh), scenario_lp(inst)

    def jloss(pp):
        r_na, r_p, _ = jsolver.solve_truncated(jp, pp)
        return jnp.log(r_na) + jnp.log(r_p)

    jval, jg = jax.value_and_grad(jloss)(jsolver.init_params())
    params = {k: v.requires_grad_() for k, v in solver.init_params().items()}
    r_na, r_p, obj = solver.solve_truncated(p, params)
    val = torch.log(r_na) + torch.log(r_p)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-8)
    for k in params:
        np.testing.assert_allclose(float(params[k].grad), float(jg[k]), rtol=1e-5, err_msg=k)


def test_pretrain_reduces_convergence_loss():
    p = scenario_lp(instance())
    solver = lp.ConsensusLPSolver()

    def loss(params):
        with torch.no_grad():
            r_na, r_p, _ = solver.solve_truncated(p, params)
        return float(torch.log(r_na) + torch.log(r_p))

    l0 = loss(solver.init_params())
    params = solver.pretrain(p, steps=10)
    l1 = loss(params)
    # best-iterate tracking guarantees never-worse than the defaults
    assert np.isfinite(l1) and l1 <= l0 + 1e-9
    assert float(params["rho"]) > 0 and float(params["sigma"]) > 0
    assert 0 < float(params["alpha"]) < 2
    assert not any(v.requires_grad for v in params.values())
    z, xs, hist, res = solver.solve(p, params=params, max_outer=40, eval_freq=40, tol=0)
    assert np.isfinite(res["objective"])


def test_sparse_operator_fallback_runs_the_same_solve(monkeypatch):
    inst = instance()
    kw = dict(max_outer=20, eval_freq=20, tol=0, adapt_rho_ph=False)
    z1, x1, _, _ = lp.ConsensusLPSolver().solve(scenario_lp(inst), **kw)
    monkeypatch.setenv("DPROX_LP_TILE_BUDGET", "16")
    p = scenario_lp(inst)
    assert not p.is_bsr
    z2, x2, _, _ = lp.ConsensusLPSolver().solve(p, **kw)
    np.testing.assert_allclose(z1, z2, atol=1e-8)


@pytest.fixture(scope="module")
def not_dividing(tmp_path_factory):
    """Each entry's error in a 2-rank gloo world on 3 scenarios
    (tests/torch_parallel_worker.py::mesh_not_dividing)."""
    import json

    import torch_parallel_worker as worker

    work = tmp_path_factory.mktemp("mesh_not_dividing")
    worker.run_world(worker.mesh_not_dividing, 2, work, 16, 4, 3)
    with open(work / "mesh_not_dividing.json") as f:
        return json.load(f)


@pytest.mark.parametrize("entry", ["solve", "solve_fused", "solve_consensus_lp"])
def test_mesh_argument_raises(not_dividing, entry):
    """A mesh whose size does not divide the scenario count raises before
    any collective (tests/test_torch_parallel.py runs the solves over a
    mesh)."""
    assert not_dividing[entry].startswith(
        "ValueError: n_scenarios=3 must divide over the 2-rank mesh axis 'scenario'"), \
        not_dividing[entry]

"""The port's iterative solvers and differentiable linear_solve against
the JAX package on the same small systems.

Solvers: the SPD systems of tests/linalg/test_linear_solver.py and
tests/test_pallas_ops.py, same rtol and cap in both packages, solutions
within atol 1e-5 of each other (float32 recurrences whose sums are
ordered differently) and within 1e-3 of the true solution. Gradients:
dL/db and dL/dtheta of L = sum(solve(A(theta), b)) against jax.grad
through dprox_tpu.linalg.linear_solve, rtol 1e-4.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dprox_tpu import linalg as jlinalg
from dprox_tpu_torch import linalg
from dprox_tpu_torch.linalg import LinearSolveConfig, linear_solve


def make_spd(n=5, seed=0, batch=1):
    rng = np.random.RandomState(seed)
    P = rng.rand(n, n)
    A = (P @ P.T + n * np.eye(n)).astype(np.float32)
    x = rng.rand(batch, n).astype(np.float32) * (10.0 ** np.arange(batch))[:, None].astype(np.float32)
    return A, x @ A.T, x


SOLVER_CASES = [  # (solver, system size, batch, rtol, max_iters)
    ("cg", 5, 1, 1e-7, 500), ("cg2", 5, 1, 1e-7, 500), ("pcg", 5, 1, 1e-7, 500),
    ("plss", 5, 1, 1e-7, 500), ("plssw", 5, 1, 1e-7, 500), ("minres", 5, 1, 1e-7, 500),
    ("cg_pallas", 8, 2, 1e-8, 50), ("cg", 8, 3, 1e-7, 500), ("pcg", 8, 3, 1e-7, 500),
    ("cg_pallas", 8, 3, 1e-7, 500), ("minres", 8, 3, 1e-7, 500)]


@pytest.mark.parametrize("name,n,batch,rtol,max_iters", SOLVER_CASES)
def test_solver_matches_jax_solver(name, n, batch, rtol, max_iters):
    A, b, x = make_spd(n, seed=n, batch=batch)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    matvecs = []
    got = linalg.SOLVERS[name](lambda v: (matvecs.append(1), v @ At.T)[1], torch.from_numpy(b),
                               rtol=rtol, max_iters=max_iters).numpy()
    ref = np.asarray(jlinalg.SOLVERS[name](lambda v: v @ Aj.T, jnp.asarray(b), rtol=rtol,
                                           max_iters=max_iters))
    scale = np.abs(x).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * scale), np.abs(got - ref).max()
    assert np.all(np.abs(got - x) <= 1e-3 * scale)
    assert 0 < len(matvecs) <= max_iters + 1  # one per iteration, one in the set-up


def test_pcg_jacobi_preconditioner_and_warm_start_match_jax():
    A, b, x = make_spd(12, seed=3)
    diag = np.diagonal(A).copy()
    x0 = (x + 0.1).astype(np.float32)
    At, dt = torch.from_numpy(A), torch.from_numpy(diag)
    got = linalg.pcg(lambda v: v @ At.T, torch.from_numpy(b), Minv=lambda r: r / dt,
                     x0=torch.from_numpy(x0), rtol=1e-8, max_iters=300).numpy()
    Aj, dj = jnp.asarray(A), jnp.asarray(diag)
    ref = np.asarray(jlinalg.pcg(lambda v: v @ Aj.T, jnp.asarray(b), Minv=lambda r: r / dj,
                                 x0=jnp.asarray(x0), rtol=1e-8, max_iters=300))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, x, rtol=0, atol=1e-3)


def test_plssw_with_weight_matches_jax():
    A, b, x = make_spd(6, seed=2)
    Wh = np.linspace(0.5, 2.0, 6).astype(np.float32)[None]
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    got = linalg.plssw(lambda v: v @ At.T, torch.from_numpy(b), Wh=torch.from_numpy(Wh),
                       rtol=1e-7, max_iters=500).numpy()
    ref = np.asarray(jlinalg.plssw(lambda v: v @ Aj.T, jnp.asarray(b), Wh=jnp.asarray(Wh),
                                   rtol=1e-7, max_iters=500))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, x, rtol=0, atol=1e-3)


def test_iteration_cap_and_all_batch_stop_rule():
    """The loop stops at max_iters, and runs until EVERY batch element is
    below its tolerance (a converged element keeps iterating with the
    others)."""
    A, b, _ = make_spd(8, seed=1, batch=2)
    At = torch.from_numpy(A)
    b = torch.from_numpy(b)

    def iterations(rhs, **kw):  # cg applies A once in its set-up, then once per iteration
        matvecs = []
        linalg.cg(lambda v: (matvecs.append(1), v @ At.T)[1], rhs, **kw)
        return len(matvecs) - 1

    assert iterations(b, rtol=1e-12, max_iters=3) == 3
    b2 = torch.cat([b[:1], torch.tensor([[1.0, -2, 3, -4, 5, -6, 7, -8]])])
    assert (iterations(b2, rtol=1e-4, max_iters=50)
            >= iterations(b[:1], rtol=1e-4, max_iters=50) > 0)


def _A_dense(theta, n, eye):
    return theta @ theta.T + n * eye


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("solver_type", ["cg", "cg_pallas"])
def test_linear_solve_gradients_match_jax(seed, solver_type):
    n = 6
    rng = np.random.RandomState(seed)
    theta = rng.rand(n, n).astype(np.float32)
    b = rng.rand(1, n).astype(np.float32)

    def loss_jax(theta, b):
        A_fn = lambda t, v: jnp.einsum("ij,bj->bi", _A_dense(t, n, jnp.eye(n)), v)
        cfg = jlinalg.LinearSolveConfig(rtol=1e-8, max_iters=500, solver_type=solver_type)
        return jnp.sum(jlinalg.linear_solve(A_fn, b, theta=theta, config=cfg))

    g_theta_ref, g_b_ref = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(theta), jnp.asarray(b))

    tt = torch.from_numpy(theta).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    A_fn = lambda t, v: torch.einsum("ij,bj->bi", _A_dense(t, n, torch.eye(n)), v)
    cfg = LinearSolveConfig(rtol=1e-8, max_iters=500, solver_type=solver_type)
    linear_solve(A_fn, bt, theta=tt, config=cfg).sum().backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(g_b_ref), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(g_theta_ref), rtol=1e-4, atol=1e-7)


def test_linear_solve_gradients_through_nested_theta_and_nonsymmetric_flag():
    """theta as (rho, {name: tensor, step: int}): gradients reach both
    tensors, the int rides along, x0 gets none; symmetric=False builds the
    transpose from the matvec and gives the same gradients for an SPD A."""
    n = 5
    rng = np.random.RandomState(7)
    P = torch.from_numpy(rng.rand(n, n).astype(np.float32))
    b = torch.from_numpy(rng.rand(2, n).astype(np.float32))

    def A_fn(theta, v):
        rho, params = theta
        W = params["w"]
        return v @ (W @ W.T).T + rho * v + 0.0 * params["__step__"]

    grads = []
    for symmetric in (True, False):
        rho = torch.tensor(0.7, requires_grad=True)
        W = P.clone().requires_grad_(True)
        bt = b.clone().requires_grad_(True)
        x0 = torch.zeros_like(b).requires_grad_(True)
        cfg = LinearSolveConfig(rtol=1e-8, max_iters=200, symmetric=symmetric)
        x = linear_solve(A_fn, bt, theta=(rho, {"w": W, "__step__": 3}), config=cfg, x0=x0)
        x.sum().backward()
        assert x0.grad is None
        grads.append((rho.grad, W.grad, bt.grad))
        # dense check of dL/db = A^-T 1
        A = (W @ W.T + rho * torch.eye(n)).detach()
        np.testing.assert_allclose(bt.grad.numpy(),
                                   torch.linalg.solve(A.T, torch.ones(n, 2)).T.numpy(),
                                   rtol=1e-4, atol=1e-6)
    for a, c in zip(*grads):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [99, 3])
def test_unrolled_gradient_matches_jax_and_the_analytic_one(seed):
    """tests/linalg/test_linear_solver_grad.py::test_unrolled_matches_analytic
    in torch: use_analytic_grad=False differentiates cg_unrolled step by
    step; its dL/dtheta and dL/db equal JAX's unrolled ones (rtol 1e-4, the
    same float32 recurrence) and the implicit ones (atol 1e-3, as there)."""
    rng = np.random.RandomState(seed)
    n = 6
    P = rng.rand(n, n).astype(np.float32)
    b = rng.rand(1, n).astype(np.float32)

    def A_fn(theta, v, xp):
        A = theta @ theta.T + n * xp.eye(n)
        return xp.einsum("ij,bj->bi", A, v)

    def grads(analytic):
        theta, bt = torch.from_numpy(P).requires_grad_(), torch.from_numpy(b).requires_grad_()
        cfg = LinearSolveConfig(rtol=1e-9, max_iters=500, use_analytic_grad=analytic)
        x = linear_solve(lambda t, v: A_fn(t, v, torch), bt, theta=theta, config=cfg)
        return torch.autograd.grad(x.sum(), (theta, bt))

    cfg = jlinalg.LinearSolveConfig(rtol=1e-9, max_iters=500, use_analytic_grad=False)
    ref = jax.grad(lambda t, bb: jnp.sum(jlinalg.linear_solve(
        lambda tt, v: A_fn(tt, v, jnp), bb, theta=t, config=cfg)), argnums=(0, 1))(
        jnp.asarray(P), jnp.asarray(b))
    unrolled, analytic = grads(False), grads(True)
    for gu, ga, gj in zip(unrolled, analytic, ref):
        np.testing.assert_allclose(gu.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gu.numpy(), ga.numpy(), atol=1e-3)


def test_pcg_solve_matches_jax():
    A, b, x = make_spd(7, seed=4)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    got = linalg.pcg_solve(lambda t, v: v @ At.T, torch.from_numpy(b), rtol=1e-8,
                           max_iters=200).numpy()
    ref = np.asarray(jlinalg.pcg_solve(lambda t, v: v @ Aj.T, jnp.asarray(b), rtol=1e-8,
                                       max_iters=200))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

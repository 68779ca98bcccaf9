"""The specializations of the port against the JAX package on the CPU.

Each case feeds both packages the same numpy inputs: the fixed-point
engines on linear contractions, the DEQ's implicit gradient (analytic and
against ``jax.grad``), the DEQ on the 32x32 nonneg deconvolution of
tests/test_specialization.py (output, Anderson's stopping step, the
gradients of ``deq_r`` / ``deq_l``; the complex CS-MRI state's real view;
annealing; Broyden), ``UnrolledSolver``'s schedule gradients,
``train_supervised`` (4 epochs, a NaN-poisoned epoch, resume), the RL
tuner's networks with carried weights, one ``train`` step, one DDPG update
of each kind, and the state helpers (``pack`` / ``unpack``, ``iters``,
``solve(return_full_states=True)``, ``solve_until``).

Tolerances: engine outputs 1e-5; the analytic gradient 1e-3 (the adjoint
stops at Anderson's eps) and 1e-4 against ``jax.grad``; DEQ outputs 1e-4
(two CPU FFTs' rounding through 20 iterations; measured 2e-6); DEQ
gradients 1e-3 relative (measured 1.3e-5); unrolled gradients 1e-4
relative; trained params 1e-4 (Adam's normalized steps carry the
gradients' last bits: measured 2.5e-5 after 16 steps); network outputs
1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.algo.special import AutoTuneSolver as JAutoTune
from dprox_tpu.algo.special.rl import CriticNet as JCritic
from dprox_tpu.algo.special import fixed_point as jfixed_point
from dprox_tpu.algo.special.training import train_supervised as jtrain_supervised
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu_torch.algo.special import (AutoTuneSolver, DEQSolver, UnrolledSolver, anderson,
                                          broyden, deq_fixed_point, load_checkpoint,
                                          train_supervised)
from dprox_tpu_torch.algo.special.rl import CriticNet, polyak
from dprox_tpu_torch.utils.checkpoint import convnet_state_dict_from_flax

ENGINE_TOL = 1e-5
DEQ_X_TOL = 1e-4
DEQ_GRAD_REL_TOL = 1e-3
REL_TOL = 1e-4
PARAM_TOL = 1e-4
NET_TOL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the test workers share the
    CPU, and a thread pool each only oversubscribes it (as in the LP test
    files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def face32():
    img = np.asarray(jimaging.sample("face"))[:, :, :32, :32].copy()
    psf = np.asarray(jimaging.point_spread_function(5, 2))
    return img, psf, np.array(jimaging.blurring(jnp.asarray(img), psf))


def _fns(pkg, face, reg="nonneg"):
    img, psf, b = face
    x = pkg.Variable()
    prior = pkg.nonneg(x) if reg == "nonneg" else pkg.norm1(pkg.grad(x, 0))
    return [pkg.sum_squares(pkg.conv(x, psf) - b), prior]


def _compile(pkg, fns, method="admm"):
    return pkg.compile(fns, method=method, **({} if pkg is jdp else {"device": "cpu"}))


class _JaxEvaluations:
    """Counts the JAX engine's evaluations of f, one counter a call of the
    engine (forward, then backward), through ``jax.debug.callback``."""

    def __init__(self, monkeypatch, name="anderson"):
        self.counts = []
        engine = jfixed_point.FIXED_POINT_SOLVERS[name]

        def counting(f, x0, **kw):
            n = len(self.counts)
            self.counts.append(0)

            def bump(_):
                self.counts[n] += 1

            def g(z):
                out = f(z)
                jax.debug.callback(bump, out)
                return out

            return engine(g, x0, **kw)

        monkeypatch.setitem(jfixed_point.FIXED_POINT_SOLVERS, name, counting)


# --------------------------------------------------------------------------- #
# Fixed-point engines
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("engine,seed,n,scale,threshold", [("anderson", 0, 8, 0.4, 50),
                                                           ("broyden", 1, 6, 0.3, 60),
                                                           ("anderson", 2, 5, 0.9, 9)])
def test_engines_on_linear_contractions_match_jax(engine, seed, n, scale, threshold):
    rng = np.random.RandomState(seed)
    A = rng.rand(n, n).astype(np.float32)
    A = (scale * A / np.abs(np.linalg.eigvals(A)).max()).astype(np.float32)
    c = rng.rand(2, n).astype(np.float32)
    jeng = jfixed_point.FIXED_POINT_SOLVERS[engine]
    ref = np.asarray(jax.jit(lambda: jeng(lambda z: jnp.einsum("ij,bj->bi", A, z) + c,
                                          jnp.zeros((2, n)), threshold=threshold, eps=1e-8))())
    At, ct = torch.from_numpy(A), torch.from_numpy(c)
    stats = {}
    got = {"anderson": anderson, "broyden": broyden}[engine](
        lambda z: torch.einsum("ij,bj->bi", At, z) + ct, torch.zeros(2, n),
        threshold=threshold, eps=1e-8, stats=stats)
    assert np.abs(_np(got) - ref).max() <= ENGINE_TOL
    if scale < 0.5:
        expect = np.linalg.solve(np.eye(n) - A, c.T).T
        assert np.abs(_np(got) - expect).max() <= 1e-3
    assert stats["evaluations"] <= threshold + 1 and stats["res"]


def test_deq_implicit_gradient_is_analytic_and_matches_jax():
    """z* = 0.5 theta + 0.5 z has z* = theta and dz*/dtheta = 1."""
    def jloss(theta):
        z = jdp.algo.special.deq_fixed_point(lambda t, z: 0.5 * t + 0.5 * z, theta,
                                             jnp.zeros((1, 4)), 50, 50, "anderson")
        return jnp.sum(z * jnp.arange(1.0, 5.0))

    theta0 = np.linspace(0.5, 2.0, 4, dtype=np.float32)[None]
    ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(theta0)))
    theta = torch.from_numpy(theta0).requires_grad_()
    z = deq_fixed_point(lambda t, z: 0.5 * t + 0.5 * z, theta, torch.zeros(1, 4), 50, 50)
    (got,) = torch.autograd.grad(torch.sum(z * torch.arange(1.0, 5.0)), theta)
    assert np.allclose(_np(got) / np.arange(1.0, 5.0), 1.0, atol=1e-3)
    assert np.abs(_np(got) - ref).max() <= 1e-4
    assert np.abs(_np(z) - theta0).max() <= 1e-3


def test_deq_nonneg_matches_jax_output_and_stopping_step(face32, monkeypatch):
    counter = _JaxEvaluations(monkeypatch)
    ref = np.asarray(jdp.algo.special.DEQSolver(_compile(jdp, _fns(jdp, face32)), f_thres=20,
                                                b_thres=20).solve(x0=face32[2], rhos=0.1,
                                                                  lams=0.05))
    stats = []
    got = DEQSolver(_compile(dp, _fns(dp, face32)), f_thres=20, b_thres=20).solve(
        x0=face32[2], rhos=0.1, lams=0.05, stats=stats)
    assert got.shape == face32[2].shape
    assert np.abs(_np(got) - ref).max() <= DEQ_X_TOL
    assert stats[0]["forward"]["evaluations"] == counter.counts[0] < 20
    assert stats[0]["forward"]["res"][-1] < 1e-3


def test_deq_learned_params_gradients_match_jax(face32, monkeypatch):
    """The ROADMAP gate tests/test_specialization.py:68-84 in torch: finite,
    non-zero gradients of deq_r / deq_l, here against jax.grad."""
    img, _, b = face32
    counter = _JaxEvaluations(monkeypatch)
    js = jdp.algo.special.DEQSolver(_compile(jdp, _fns(jdp, face32)), learned_params=True,
                                    f_thres=15, b_thres=15)
    ref = jax.jit(jax.grad(lambda p: jnp.mean((js.solve(x0=b, rhos=0.1, lams=0.05, params=p)
                                               - img) ** 2)))(js.init_params())
    s = DEQSolver(_compile(dp, _fns(dp, face32)), learned_params=True, f_thres=15, b_thres=15)
    params = {k: v.requires_grad_() for k, v in s.init_params().items()}
    stats = []
    out = s.solve(x0=b, rhos=0.1, lams=0.05, params=params, stats=stats)
    loss = torch.mean((out - torch.from_numpy(img)) ** 2)
    got = torch.autograd.grad(loss, [params["deq_r"], params["deq_l"]], allow_unused=True)
    got = {k: 0.0 if g is None else float(g) for k, g in zip(("deq_r", "deq_l"), got)}
    assert np.isfinite(got["deq_r"]) and abs(got["deq_r"]) + abs(got["deq_l"]) > 0
    scale = max(abs(float(ref["deq_r"])), abs(float(ref["deq_l"])))
    for k in ("deq_r", "deq_l"):
        assert abs(got[k] - float(ref[k])) <= DEQ_GRAD_REL_TOL * scale, (k, got, ref)
    assert [stats[0]["forward"]["evaluations"], stats[0]["backward"]["evaluations"]] \
        == counter.counts


def test_deq_complex_state_real_view_matches_jax():
    """CS-MRI's complex packed state runs the engine on [Re z; Im z]; a
    real output from a real x0, and a complex x0 keeps its imaginary part."""
    from dprox_tpu.contrib import csmri as jcsmri

    s = jcsmri.generate_sample(size=48, num_lines=24)

    def solver(pkg):
        x = pkg.Variable()
        fns = pkg.csmri(x, pkg.Placeholder("mask", batch=False), pkg.Placeholder("y")) \
            + pkg.deep_prior(x, "tv", sqrt=True)
        return _compile(pkg, fns)

    kw = dict(rhos=0.5, lams=0.02, params=dict(s["params"]), real_output=True)
    for x0 in (np.real(s["x0"]).astype(np.float32), s["x0"]):
        ref = np.asarray(jdp.algo.special.DEQSolver(solver(jdp), f_thres=20, b_thres=10)
                         .solve(x0=x0, **kw))
        got = DEQSolver(solver(dp), f_thres=20, b_thres=10).solve(x0=x0, **kw)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert np.abs(_np(got) - ref).max() <= DEQ_X_TOL


@pytest.mark.parametrize("kind", ["anneal", "broyden"])
def test_deq_anneal_and_broyden_match_jax(face32, kind):
    """Annealing on norm1(grad(x)) (3 levels of a 4-level schedule, 3
    iterations each), Broyden on the nonneg problem."""
    b = face32[2]
    if kind == "anneal":
        kw, reg = dict(f_thres=3, b_thres=5, anneal=3), "norm1"
        solve_kw = dict(rhos=np.array([0.3, 0.2, 0.1, 0.05], np.float32),
                        lams=np.array([0.05, 0.03, 0.02, 0.01], np.float32))
    else:
        kw, reg = dict(f_thres=12, b_thres=12, solver_type="broyden"), "nonneg"
        solve_kw = dict(rhos=0.1, lams=0.05)
    ref = np.asarray(jdp.algo.special.DEQSolver(_compile(jdp, _fns(jdp, face32, reg)), **kw)
                     .solve(x0=b, **solve_kw))
    got = DEQSolver(_compile(dp, _fns(dp, face32, reg)), **kw).solve(x0=b, **solve_kw)
    assert np.abs(_np(got) - ref).max() <= DEQ_X_TOL


def test_deq_precision_restores_flags(face32):
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    DEQSolver(_compile(dp, _fns(dp, face32)), f_thres=4, b_thres=4).solve(
        x0=face32[2], rhos=0.1, lams=0.05)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    with pytest.raises(ValueError):
        DEQSolver(_compile(dp, _fns(dp, face32)), precision="high")


# --------------------------------------------------------------------------- #
# Unrolling and supervised training
# --------------------------------------------------------------------------- #

def test_unrolled_schedule_gradients_match_jax(face32):
    img, _, b = face32
    js = jdp.algo.special.UnrolledSolver(_compile(jdp, _fns(jdp, face32, "norm1")), max_iter=5,
                                         learned_params=True, rhos=0.05, lams=0.01)
    ref = jax.jit(jax.grad(lambda p: jnp.mean((js.solve(x0=b, params=p) - img) ** 2)))(
        js.init_params())
    s = UnrolledSolver(_compile(dp, _fns(dp, face32, "norm1")), max_iter=5,
                       learned_params=True, rhos=0.05, lams=0.01)
    params = s.init_params()
    assert params["unroll_rhos"].shape == (5,)
    params = {"unroll_rhos": params["unroll_rhos"].requires_grad_(),
              "unroll_lams": tuple(l.requires_grad_() for l in params["unroll_lams"])}
    loss = torch.mean((s.solve(x0=b, params=params) - torch.from_numpy(img)) ** 2)
    g_rho, g_lam = torch.autograd.grad(loss, [params["unroll_rhos"], params["unroll_lams"][0]])
    assert float(g_rho.abs().sum()) > 0 and float(g_lam.abs().sum()) > 0
    assert _rel(_np(g_rho), ref["unroll_rhos"]) <= REL_TOL
    assert _rel(_np(g_lam), ref["unroll_lams"][0]) <= REL_TOL


def test_build_unrolled_solver_share_pins_solve(face32):
    s = dp.specialize(_compile(dp, _fns(dp, face32)), "unroll", share=True, max_iter=5,
                      rhos=0.05, lams=0.01)
    ref = jdp.specialize(_compile(jdp, _fns(jdp, face32)), "unroll", share=True, max_iter=5,
                         rhos=0.05, lams=0.01)
    out = s.solve(x0=face32[2])
    assert out.shape == face32[2].shape
    assert np.abs(_np(out) - np.asarray(ref.solve(x0=face32[2]))).max() <= 1e-5


def _training_case(face32, poison):
    img, _, b = face32
    data = [{"b": b, "gt": img, "poison": np.array(poison and i % 2 == 1)} for i in range(4)]

    def jstep(params, batch, key):
        loss = jnp.mean((jus.solve(x0=batch["b"], params=params) - batch["gt"]) ** 2)
        return jnp.where(batch["poison"], jnp.nan, loss)

    def step(params, batch, generator):
        loss = torch.mean((us.solve(x0=batch["b"], params=params)
                           - torch.from_numpy(batch["gt"])) ** 2)
        return torch.where(torch.from_numpy(batch["poison"]), torch.nan, loss)

    kw = dict(rhos=0.5, lams=0.05, max_iter=4, learned_params=True)
    jus = jdp.algo.special.UnrolledSolver(_compile(jdp, _fns(jdp, face32, "norm1")), **kw)
    us = UnrolledSolver(_compile(dp, _fns(dp, face32, "norm1")), **kw)
    return data, jstep, step, jus, us


@pytest.mark.parametrize("poison", [False, True])
def test_train_supervised_matches_jax(face32, poison, tmp_path):
    """4 epochs of 4 steps (AdamW, lr 5e-3), and an epoch whose every second
    step is NaN: the NaN guard zeroes the gradients and still steps, so the
    moments decay and the weight decay moves the params, as optax does."""
    data, jstep, step, jus, us = _training_case(face32, poison)
    epochs, lr = (1, 1e-2) if poison else (4, 5e-3)
    ref = jtrain_supervised(jstep, data, jus.init_params(), epochs=epochs, lr=lr, log_every=0)
    got = train_supervised(step, data, us.init_params(), epochs=epochs, lr=lr, log_every=0,
                           savedir=str(tmp_path))
    assert np.abs(_np(got["unroll_rhos"]) - np.asarray(ref["unroll_rhos"])).max() <= PARAM_TOL
    assert np.abs(_np(got["unroll_lams"][0]) - np.asarray(ref["unroll_lams"][0])).max() \
        <= PARAM_TOL
    assert all(np.isfinite(_np(t)).all() for t in (got["unroll_rhos"], *got["unroll_lams"]))
    params, opt_state, epoch, gstep, _ = load_checkpoint(str(tmp_path / "last.ckpt"))
    assert (epoch, gstep) == (epochs, 4 * epochs)
    assert torch.equal(params["unroll_rhos"], got["unroll_rhos"])
    assert all(int(s["step"]) == 4 * epochs for s in opt_state["state"].values())


def test_train_supervised_resumes_counters_and_params(face32, tmp_path):
    data, _, step, _, us = _training_case(face32, False)
    img, _, b = face32

    def eval_fn(params):
        return dp.utils.metrics.psnr(us.solve(x0=b, params=params), img)

    before = eval_fn(us.init_params())
    first = train_supervised(step, data, us.init_params(), epochs=2, lr=5e-3, log_every=0,
                             savedir=str(tmp_path), eval_fn=eval_fn)
    assert eval_fn(first) > before
    best = load_checkpoint(str(tmp_path / "best.ckpt"))
    assert best[2:4] == (1, 8) and best[4] == pytest.approx(eval_fn(first))
    resumed = train_supervised(step, data, us.init_params(), epochs=4, lr=5e-3, log_every=0,
                               savedir=str(tmp_path), resume=True, eval_fn=eval_fn)
    straight = train_supervised(step, data, us.init_params(), epochs=4, lr=5e-3, log_every=0)
    assert _rel(_np(resumed["unroll_rhos"]), _np(straight["unroll_rhos"])) <= 1e-6
    assert load_checkpoint(str(tmp_path / "last.ckpt"))[2:4] == (4, 16)


# --------------------------------------------------------------------------- #
# The RL tuner
# --------------------------------------------------------------------------- #

def _jax_tuner(face32, **kw):
    return JAutoTune(_compile(jdp, _fns(jdp, face32)), action_pack=2, max_episode_step=2, **kw)


def _tuner(face32, **kw):
    return AutoTuneSolver(_compile(dp, _fns(dp, face32)), action_pack=2, max_episode_step=2,
                          **kw)


def _carry(jparams, tuner):
    tuner.policy_params = convnet_state_dict_from_flax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("shape", [(2, 5, 32, 32), (1, 5, 37, 50)])
def test_policy_and_critic_forward_match_jax(face32, shape):
    """flax SAME padding at stride 2 (0 before, 1 after on an even size)
    and the HWIO -> OIHW carry: the same actions and Q values."""
    rng = np.random.RandomState(3)
    ob = rng.rand(*shape).astype(np.float32)
    jt, t = _jax_tuner(face32), _tuner(face32)
    _carry(jt.policy_params, t)
    ref = jax.jit(jt.policy.apply)(jt.policy_params, jnp.asarray(ob.transpose(0, 2, 3, 1)))
    got = t.policy(torch.from_numpy(ob))
    for k in ("rho", "sigmas", "idx_stop"):
        assert got[k].shape == ref[k].shape
        assert np.abs(_np(got[k]) - np.asarray(ref[k])).max() <= NET_TOL, k
    act = rng.rand(shape[0], 5).astype(np.float32)
    critic = JCritic()
    cp = jax.jit(critic.init)(jax.random.key(1), jnp.asarray(ob.transpose(0, 2, 3, 1)),
                              jnp.asarray(act))
    net = CriticNet(shape[1], 5)
    net.load_state_dict(convnet_state_dict_from_flax(jax.tree.map(np.asarray, cp)))
    q_ref = jax.jit(critic.apply)(cp, jnp.asarray(ob.transpose(0, 2, 3, 1)), jnp.asarray(act))
    q = net(torch.from_numpy(ob), torch.from_numpy(act))
    assert np.abs(_np(q) - np.asarray(q_ref)).max() <= NET_TOL


def _adam_close(got, ref, lr):
    """Adam's first update is lr g / (|g| + 1e-8): a gradient entry within a
    few 1e-8 of 0 turns its last bits into a fair part of lr, so weights
    after a step are held to lr / 4 (their gradients to 1e-4 relative)."""
    ref = convnet_state_dict_from_flax(jax.tree.map(np.asarray, ref))
    return max(np.abs(_np(got[k]) - _np(ref[k])).max() for k in ref) <= lr / 4


def test_tuner_episode_and_train_step_match_jax(face32):
    img, _, b = face32
    jt, t = _jax_tuner(face32), _tuner(face32)
    _carry(jt.policy_params, t)
    assert np.abs(_np(t.solve(b)) - np.asarray(jt.solve(b))).max() <= 1e-5
    # the train step's gradient
    ref = jax.jit(jax.grad(lambda p: jnp.mean((jt._episode(p, jnp.asarray(b)) - img) ** 2)))(
        jt.policy_params)
    ref = convnet_state_dict_from_flax(jax.tree.map(np.asarray, ref))
    params = {k: v.requires_grad_() for k, v in t.policy_params.items()}
    loss = torch.mean((t._episode(params, b) - torch.from_numpy(img)) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    got = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(params.items(), grads)}
    scale = max(float(ref[k].abs().max()) for k in ref)
    assert scale > 0 and max(float((got[k] - ref[k]).abs().max()) for k in ref) <= REL_TOL * scale
    dataset = [{"x0": b, "gt": img}]
    ref = jt.train(dataset, epochs=1, log_every=0, lr=1e-3)
    got = t.train(dataset, epochs=1, log_every=0, lr=1e-3)
    assert _adam_close(got, ref, 1e-3)
    assert np.isfinite(_np(t.solve(b, params=got))).all()
    assert dp.train(t, dataset=dataset, epochs=1, log_every=0).keys() == got.keys()


def test_tuner_train_checkpoint_holds_the_best_steps_opt_state(face32, tmp_path):
    """Under eval_fn selection the checkpoint pairs the selected params
    with the optimizer state and step they were taken at (the JAX package
    saves the last step's), while the returned params equal JAX's."""
    img, _, b = face32
    jt, t = _jax_tuner(face32), _tuner(face32)
    _carry(jt.policy_params, t)
    start = t.policy_params
    dataset = [{"x0": b, "gt": img}] * 4

    def scores():  # after steps 1-4, then the final params: step 2 scores best
        it = iter([3.0, 5.0, 1.0, 2.0, 0.0])
        return lambda params: next(it)

    ref = jt.train(dataset, log_every=0, lr=1e-3, eval_fn=scores(), eval_every=1)
    got = t.train(dataset, log_every=0, lr=1e-3, eval_fn=scores(), eval_every=1,
                  savedir=str(tmp_path))
    assert _adam_close(got, ref, 1e-3)
    params, opt_state, epoch, step, _ = load_checkpoint(str(tmp_path / "policy.ckpt"))
    assert step == 2 and epoch == 0
    assert all(int(s["step"]) == 2 for s in opt_state["state"].values())
    assert all(torch.equal(params[k], got[k]) for k in got)
    replay = _tuner(face32)
    replay.policy_params = start
    twice = replay.train(dataset[:2], log_every=0, lr=1e-3)
    assert all(torch.equal(twice[k], got[k]) for k in got)


def test_ddpg_updates_match_jax(face32):
    """One critic update, one actor update and one Polyak step from the
    same weights and batch, each against the JAX package's update
    (rl.py's closures, written out here with the same optax chain)."""
    jt, t = _jax_tuner(face32), _tuner(face32)
    _carry(jt.policy_params, t)
    rng = np.random.RandomState(4)
    B, A = 4, 2 + 2 + 1
    batch = {"ob": rng.rand(B, 5, 32, 32), "act": rng.rand(B, A), "rew": rng.randn(B),
             "nob": rng.rand(B, 5, 32, 32), "done": (rng.rand(B) > 0.5)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    nhwc = {k: jnp.asarray(v.transpose(0, 2, 3, 1) if v.ndim == 4 else v)
            for k, v in batch.items()}
    critic = JCritic()
    cp = jax.jit(critic.init)(jax.random.key(0), nhwc["ob"], nhwc["act"])
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-4))
    gamma, ymax = 0.99, 10.0 * 2
    jflat = jt._flat_action
    ap = jt.policy_params
    na = jflat(jax.jit(jt.policy.apply)(ap, nhwc["nob"]))
    y = jnp.clip(nhwc["rew"] + gamma * (1.0 - nhwc["done"])
                 * jax.jit(critic.apply)(cp, nhwc["nob"], na),
                 -ymax, ymax)
    closs, cgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean((critic.apply(p, nhwc["ob"], nhwc["act"]) - y) ** 2)))(cp)
    upd, _ = tx.update(cgrads, tx.init(cp))
    cp_new = optax.apply_updates(cp, upd)
    atx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
    aloss, agrads = jax.jit(jax.value_and_grad(
        lambda p: -jnp.mean(critic.apply(cp_new, nhwc["ob"], jflat(jt.policy.apply(p, nhwc["ob"])))
                            )))(ap)
    upd, _ = atx.update(agrads, atx.init(ap))
    ap_new = optax.apply_updates(ap, upd)
    target = jax.tree.map(lambda tt, p: (1 - 0.005) * tt + 0.005 * p, ap, ap_new)

    net = CriticNet(5, A)
    net.load_state_dict(convnet_state_dict_from_flax(jax.tree.map(np.asarray, cp)))
    actor_target, critic_target = copy.deepcopy(t.policy), copy.deepcopy(net)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    c_opt = torch.optim.Adam(net.parameters(), lr=3e-4)
    a_opt = torch.optim.Adam(t.policy.parameters(), lr=1e-4)
    c_loss = t.critic_update(net, c_opt, actor_target, critic_target, tb, gamma, ymax, 1.0)
    a_loss = t.actor_update(a_opt, net, tb["ob"], 1.0)
    polyak(actor_target, t.policy, 0.005)
    assert abs(float(c_loss) - float(closs)) <= 1e-5 * max(1.0, abs(float(closs)))
    assert abs(float(a_loss) - float(aloss)) <= 1e-5 * max(1.0, abs(float(aloss)))
    assert _adam_close(net.state_dict(), cp_new, 3e-4)
    assert _adam_close(t.policy.state_dict(), ap_new, 1e-4)
    assert _adam_close(actor_target.state_dict(), target, 0.005 * 1e-4)


def test_train_ddpg_moves_the_policy(face32):
    """The JAX test's behavioural checks (its trajectory cannot be matched:
    the critic's initial weights come from jax.random)."""
    img, _, b = face32
    t = _tuner(face32)
    before = t.policy_params
    params = t.train_ddpg([{"x0": b, "gt": img}] * 3, epochs=1, batch_size=4, warmup=4,
                          noise_scale=0.02)
    assert any(not torch.allclose(before[k], params[k]) for k in before)
    assert np.isfinite(_np(t.solve(b, params=params))).all()
    assert all(p.device.type == "cpu" for p in t.policy.parameters())


# --------------------------------------------------------------------------- #
# State helpers, registries
# --------------------------------------------------------------------------- #

def test_pack_unpack_iters_and_full_states_match_jax(face32):
    b = face32[2]
    js, s = _compile(jdp, _fns(jdp, face32, "norm1")), _compile(dp, _fns(dp, face32, "norm1"))
    assert (s.state_split, s.state_dim, s.nparams) == (js.state_split, js.state_dim, js.nparams)
    state = s.initialize(torch.from_numpy(b), {})
    packed = s.pack(state)
    assert packed.shape[1] == b.shape[1] * 3
    x, v, u = s.unpack(packed)
    assert torch.equal(x, state[0]) and torch.equal(v[0], state[1][0])
    rng = np.random.RandomState(5)
    rhos = rng.uniform(0.05, 0.2, (1, 3)).astype(np.float32)
    lams = [rng.uniform(0.005, 0.02, (1, 3)).astype(np.float32)]
    ref = js.iters(js.initialize(jnp.asarray(b), {}), rhos, lams, 3, x_ref=jnp.asarray(b))
    got = s.iters(state, torch.from_numpy(rhos), [torch.from_numpy(lams[0])], 3,
                  x_ref=torch.from_numpy(b))
    assert np.abs(_np(s.pack(got)) - np.asarray(js.pack(ref))).max() <= 1e-5
    traj = s.solve(x0=b, max_iter=4, return_full_states=True)
    jtraj = js.solve(x0=b, max_iter=4, return_full_states=True)
    assert traj[0].shape == jtraj[0].shape == (4,) + b.shape
    assert np.abs(_np(traj[2][0]) - np.asarray(jtraj[2][0])).max() <= 1e-5


@pytest.mark.parametrize("method,split", [("hqs", [1, [1]]), ("pc", [1, [1], 1]),
                                          ("pgd", [1]), ("cadmm", [1, [2], [2]])])
def test_state_split_of_each_solver_matches_jax(face32, method, split):
    fns = _fns(dp, face32)
    jfns = _fns(jdp, face32)
    s, js = _compile(dp, fns, method), _compile(jdp, jfns, method)
    assert s.state_split == js.state_split == split
    state = s.initialize(torch.from_numpy(face32[2]), {})
    assert s.pack(state).shape[1] == s.state_dim * face32[2].shape[1]


def test_solve_until_stops_where_jax_stops():
    img = np.asarray(jimaging.sample("face"))[:, :, :64, :64].copy()
    psf = np.asarray(jimaging.point_spread_function(15, 5))
    b = np.array(jimaging.blurring(jnp.asarray(img), psf))

    def fns(pkg):
        x = pkg.Variable()
        return [pkg.sum_squares(pkg.conv(x, psf) - b), pkg.nonneg(x)]

    ref, k_ref = _compile(jdp, fns(jdp)).solve_until(x0=b, max_iter=300, tol=1e-4, rhos=0.05,
                                                     lams=0.01)
    solver = _compile(dp, fns(dp))
    got, k = solver.solve_until(x0=b, max_iter=300, tol=1e-4, rhos=0.05, lams=0.01)
    assert 0 < k < 300 and k == int(k_ref)
    assert np.abs(_np(got) - np.asarray(ref)).max() <= 1e-5
    with pytest.raises(NotImplementedError):
        _compile(dp, fns(dp), "pc").solve_until(x0=b, max_iter=2)


def test_specialize_registry_and_deep_prior_unroll():
    from dprox_tpu_torch.algo.special import SPECIALIZATIONS

    assert set(SPECIALIZATIONS) == set(jdp.algo.special.SPECIALIZATIONS)
    x = dp.Variable()
    prior = dp.deep_prior(x, "tiny_ffdnet", unroll_step=3)
    w = prior.unrolled_params["convs.0.weight"]
    assert w.shape[0] == 3 and torch.equal(w[0], w[2])
    v = torch.from_numpy(np.random.RandomState(6).rand(1, 1, 16, 16).astype(np.float32))
    lam = torch.tensor(0.05)
    scaled = {k: v2 * torch.arange(1.0, 4.0).reshape((3,) + (1,) * (v2.ndim - 1))
              for k, v2 in prior.unrolled_params.items()}
    prior.param_key = "w"
    outs = [prior._prox(v, lam, params={"w": scaled}, step=k) for k in (0, 2, 7)]
    assert not torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])

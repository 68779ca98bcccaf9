"""The shipped trained specialized solvers in the port against the JAX
package on the CPU.

- The trained CS-MRI DEQ (weights/deq_csmri.msgpack) on both cells of
  tests/paper/test_csmri_grid.py::DEQ_GRID, with Anderson's stopping step;
- the color DEQ (weights/deq_deconv.msgpack) on held-out hopper cell 0 of
  tests/paper/test_deconv_deq.py;
- the CS-MRI policy (weights/autotune_csmri.msgpack) against log_descent at
  the same 30-iteration budget (tests/test_specialization.py);
- the deconv and demosaic policies (weights/autotune_{deconv,demosaic})
  on the 4 held-out samples of tests/test_specialization.py::
  test_autotune_shipped_policy_cross_task.

Each PSNR within 0.01 dB of the JAX package's on the same inputs (measured
<= 1e-5 dB); each golden pin as loosely as its JAX test holds it. JAX runs
in the test where that costs seconds; the cross-task PSNRs (their JAX
baselines take minutes) are pinned from
    JAX_PLATFORMS=cpu python scripts/smoke_references.py special
(key "cross_task"), their samples made by the JAX package's own script.
"""
import os
import sys

import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.contrib import csmri as jcsmri
from dprox_tpu.proxfn.pnp.prior import get_denoiser as jget_denoiser
from dprox_tpu.utils import metrics as jmetrics
from dprox_tpu_torch.proxfn.pnp.prior import get_denoiser
from dprox_tpu_torch.utils import metrics
from dprox_tpu_torch.utils.checkpoint import deq_params_from_flax, load_flax_msgpack

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.abspath(os.path.join(ROOT, "scripts")))

PSNR_TOL = 0.01
DEQ_GRID = [(50, 0.0, 30.99, 30.75), (40, 0.05, 27.51, 22.76)]  # (lines, sigma, golden, PnP)
# scripts/smoke_references.py special, "cross_task": [tuned, baseline] per sample
CROSS_TASK = {"deconv": [[27.233320528593417, 29.932416201753057],
                         [26.73027997705074, 30.969679734048206],
                         [23.233313852682866, 4.282787791125555],
                         [21.738765441372298, 5.152256182899785]],
              "demosaic": [[28.934108965316753, 28.579499443011823],
                           [28.07620426466887, 27.95689125443912],
                           [25.72370144350875, 25.683422434697732],
                           [24.089364303683073, 24.03027357535541]]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the test workers share the
    CPU, and a thread pool each only oversubscribes it (as in the LP test
    files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(name):
    return os.path.join(ROOT, "weights", name)


def _jax_params(template, name):
    from flax import serialization

    with open(_weights(name), "rb") as f:
        return serialization.from_bytes(template, f.read())


@pytest.mark.parametrize("lines,sigma,golden,pnp", DEQ_GRID)
def test_trained_csmri_deq_matches_jax(lines, sigma, golden, pnp):
    s = jcsmri.generate_sample(size=128, num_lines=lines, sigma=sigma)
    x0 = np.real(s["x0"]).astype(np.float32)

    jden = jget_denoiser("distilled_gray")
    x = jdp.Variable()
    jdeq = jdp.specialize(jdp.compile(
        jdp.csmri(x, jdp.Placeholder("mask", batch=False), jdp.Placeholder("y"))
        + jdp.deep_prior(x, jden, sqrt=True, param_key="deq_prior"), "admm"),
        "deq", learned_params=True, f_thres=24, b_thres=16)
    jp = _jax_params({"deq_r": np.float32(1.0), "deq_l": np.float32(1.0),
                      "deq_prior": jden.params}, "deq_csmri.msgpack")
    ref = jmetrics.psnr(np.asarray(jdeq.solve(x0=x0, rhos=0.3, lams=0.05,
                                              params=dict(jp, **s["params"]),
                                              real_output=True)), s["gt"])

    x = dp.Variable()
    deq = dp.specialize(dp.compile(
        dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
        + dp.deep_prior(x, get_denoiser("distilled_gray"), sqrt=True, param_key="deq_prior"),
        "admm", device="cpu"), "deq", learned_params=True, f_thres=24, b_thres=16)
    params = deq_params_from_flax(load_flax_msgpack(_weights("deq_csmri.msgpack")))
    stats = []
    out = deq.solve(x0=x0, rhos=0.3, lams=0.05, params=dict(params, **s["params"]),
                    real_output=True, stats=stats)
    got = metrics.psnr(out.numpy(), s["gt"])
    assert got == pytest.approx(ref, abs=PSNR_TOL), (got, ref)
    assert got == pytest.approx(golden, abs=0.15) and got > pnp
    # no early stop at this budget (scripts/smoke_references.py: 24 in JAX)
    assert stats[0]["forward"]["evaluations"] == 24


def test_trained_color_deq_matches_jax_on_hopper_cell():
    import train_deq_deconv as D

    prob = D.heldout_problems()[0]
    jdeq, jden = D.build_deq()
    jp = _jax_params(dict(jdeq.init_params(), deq_prior=jden.params), "deq_deconv.msgpack")
    ref = D.deq_psnr(jdeq, prob, jp)

    x = dp.Variable()
    data = dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf"), circular=True),
                          b=dp.Placeholder("y"))
    solver = dp.compile(data + dp.deep_prior(x, get_denoiser("distilled_color"),
                                             param_key="deq_prior"), "admm", device="cpu")
    deq = dp.specialize(solver, "deq", learned_params=True, f_thres=24, b_thres=16)
    params = deq_params_from_flax(load_flax_msgpack(_weights("deq_deconv.msgpack")))
    rho, lam = D.deq_base(prob["sigma_n"])
    out = deq.solve(x0=prob["y"], rhos=rho, lams=lam,
                    params=dict(params, psf=prob["psf"], y=prob["y"]), real_output=True)
    got = metrics.psnr(np.clip(out.numpy(), 0, 1), prob["gt"])
    assert got == pytest.approx(ref, abs=PSNR_TOL), (got, ref)
    assert got == pytest.approx(30.42, abs=0.2)  # tests/paper/test_deconv_deq.py's pin


def test_shipped_csmri_policy_matches_jax_and_beats_log_descent():
    from dprox_tpu.algo.special import AutoTuneSolver as JAutoTune

    s = jcsmri.generate_sample(size=128, num_lines=40, sigma=0.05)
    x0 = np.real(s["x0"]).astype(np.float32)
    x = jdp.Variable()
    jtuner = JAutoTune(jdp.compile(jdp.csmri(x, jdp.Placeholder("mask", batch=False),
                                             jdp.Placeholder("y"))
                                   + jdp.deep_prior(x, "tv", sqrt=True), "admm"),
                       action_pack=5, max_episode_step=6)
    jtuner.policy_params = _jax_params(jtuner.policy_params, "autotune_csmri.msgpack")
    ref = jmetrics.psnr(np.real(np.asarray(jtuner.solve(x0, solve_params=s["params"]))),
                        s["gt"])

    x = dp.Variable()
    solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                        + dp.deep_prior(x, "tv", sqrt=True), "admm", device="cpu")
    tuner = dp.specialize(solver, "rl", action_pack=5, max_episode_step=6)
    tuner.load(_weights("autotune_csmri.msgpack"))
    got = metrics.psnr(tuner.solve(x0, solve_params=s["params"]).real.numpy(), s["gt"])
    rhos, sigmas = dp.log_descent(30, 5, 30, sigma=0.01)
    base = metrics.psnr(solver.solve(x0=s["x0"], rhos=rhos, lams=sigmas, max_iter=30,
                                     params=s["params"], real_output=True).numpy(), s["gt"])
    assert got == pytest.approx(ref, abs=PSNR_TOL), (got, ref)
    assert got > base + 1.0, (got, base)  # recorded: 23.29 against 20.24


def _cross_task_tuner(task):
    """The port's scripts/train_autotune_multi.py::build_tuner."""
    x = dp.Variable()
    b = dp.Placeholder("b")
    K = dp.conv_doe(x, dp.Placeholder("psf", batch=False)) if task == "deconv" else dp.mosaic(x)
    solver = dp.compile(dp.sum_squares(K - b) + dp.deep_prior(x, "tv"), "admm", device="cpu")
    naux = 2 if task == "deconv" else 1

    def pack(variables, x0c, T, aux):
        B, _, H, W = x0c.shape
        amap = torch.as_tensor(np.asarray(aux, np.float32))[:, :, None, None].expand(
            B, naux, H, W)
        return torch.cat([variables, x0c, T, amap], dim=1)

    tuner = dp.AutoTuneSolver(solver, action_pack=5, max_episode_step=6,
                              ob_dim=solver.state_dim + 2 + naux, custom_policy_ob_pack_fn=pack)
    tuner.load(_weights(f"autotune_{task}.msgpack"))
    return tuner, solver


def _baseline(task, solver, sample, n):
    """train_autotune_multi.py's baselines: log_descent(35, 10) for
    deconv, the best of its four schedules for demosaic."""
    sn = sample["sigma_n"]
    schedules = [dp.log_descent(35, 10, n)]
    if task == "demosaic":
        schedules += [dp.log_descent(35 + 600 * sn, 10 + 300 * sn, n)] + [
            dp.log_descent(80, 25 + 600 * sn, n, sigma=max(sn, 0.001), lam=0.23 * m)
            for m in (10, 30)]
    return max(metrics.psnr(np.clip(solver.solve(x0=sample["x0"], rhos=r, lams=s, max_iter=n,
                                                 params=sample["params"]).numpy(), 0, 1),
                            sample["gt"]) for r, s in schedules)


@pytest.mark.parametrize("task", ["deconv", "demosaic"])
def test_shipped_cross_task_policies_match_jax(task):
    import train_autotune_multi as M

    tuner, solver = _cross_task_tuner(task)
    gains = []
    for sample, (ref_tuned, ref_base) in zip(M.make_samples(task, 4, seed0=9000),
                                              CROSS_TASK[task]):
        out = tuner.solve(sample["x0"], aux_state=sample["aux"], solve_params=sample["params"])
        tuned = metrics.psnr(np.clip(out.real.numpy(), 0, 1), sample["gt"])
        base = _baseline(task, solver, sample, M.EPISODE_ITERS)
        assert tuned == pytest.approx(ref_tuned, abs=PSNR_TOL), (tuned, ref_tuned)
        assert base == pytest.approx(ref_base, abs=PSNR_TOL), (base, ref_base)
        gains.append(tuned - base)
    assert np.mean(gains) > 0, gains

"""The zoo's goldens in the port, on the CPU.

The tiny_drunet_color_tv deconvolution on the face's 128x128 crop, the
four HSI_GRID cells of tests/paper/test_hsi_grid.py (and mid_grunet above
tiny_grunet), the two DERAIN_GOLDEN cells of tests/test_training.py with
the shipped derain pipeline, the derain joint-training gradients against
jax.grad, unrolled_prior with pgd (trajectory included), and the
ensemble_tv and patch_nlm tests of tests/test_pnp.py against the JAX
package.

The JAX package's PSNRs of the solves are pinned (JAX_CPU below), printed
under "zoo" by
    JAX_PLATFORMS=cpu python scripts/smoke_references.py zoo
on the same inputs, which chip_smoke.py's helpers make for both packages
(blur64, hsi_problem, derain_crops: numpy float64 observations, the rainy
crops that script wrote with the JAX package's synthetic_rain). Tolerances:
0.01 dB of JAX's PSNR (measured gaps <= 3e-5 dB), 0.2 dB of the HSI goldens,
0.15 dB of the derain goldens (as their own tests); gradients 1e-4 of the
largest entry of each group; network outputs and trajectories 1e-5 of
their largest magnitude.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.contrib.derain import LearnableDegOp as JaxDegOp
from dprox_tpu.models.dgu import DGUDenoiser as JaxDGU
from dprox_tpu.proxfn.pnp.prior import get_denoiser as jax_get_denoiser
from dprox_tpu_torch.models.dgu import DGUDenoiser
from dprox_tpu_torch.proxfn.pnp.prior import get_denoiser
from dprox_tpu_torch.utils import checkpoint as ck
from dprox_tpu_torch.utils import metrics
from dprox_tpu_torch.utils.imaging import point_spread_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from test_torch_zoo import DGU_KW, _close, _flax_params  # noqa: E402

JAX_CPU = {"tiny_drunet_color_tv_128": 28.198564554398754,
           "hsi_deblur": 29.50638059713327, "hsi_sisr": 29.32161004891281,
           "hsi_misr": 34.57077746098304, "hsi_cs": 30.352899377916117,
           "denoise_tiny_grunet": 32.15857941964991, "denoise_mid_grunet": 32.49361470557747,
           "derain_0": 31.006056314160276, "derain_4": 33.957510850004724}
HSI_GOLDEN = {"deblur": 29.51, "sisr": 29.32, "misr": 34.57, "cs": 30.35}
DERAIN_GOLDEN = [(0, 22.54, 31.01), (4, 21.77, 33.96)]  # tests/test_training.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the test workers share the
    CPU (as in the LP test files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hwc(a):
    return np.transpose(np.asarray(a)[0], (1, 2, 0))


def test_drunet_tv_deconvolution_128():
    """deep_prior(x, "tiny_drunet_color_tv") deconvolution of the face's
    128x128 crop, psf(15, 5), log_descent(80, 25, 24), 24 iterations."""
    from dprox_tpu_torch.utils.imaging import _synthetic_face

    img = _synthetic_face(512, 512)[:128, :128].transpose(2, 0, 1)[None].astype(np.float32)
    psf = point_spread_function(15, 5)
    b = cs.blur64(img, psf)
    x = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - torch.from_numpy(b)),
                         dp.deep_prior(x, "tiny_drunet_color_tv")], "admm", device="cpu")
    rhos, sigmas = dp.log_descent(80, 25, 24)
    with torch.no_grad():
        out = solver.solve(x0=torch.from_numpy(b), max_iter=24, rhos=rhos, lams=sigmas)
    got = metrics.psnr(out, torch.from_numpy(img))
    assert got == pytest.approx(JAX_CPU["tiny_drunet_color_tv_128"], abs=0.01)
    assert got > metrics.psnr(torch.from_numpy(b), torch.from_numpy(img)) + 2.0


@pytest.mark.parametrize("task,prior", cs.HSI_GRID)
def test_hsi_grid(task, prior):
    gt, srf = cs.synthetic_hsi()
    solver, x0 = cs.hsi_problem(dp, task, prior, gt, srf, "cpu")
    rhos, sigmas = cs.hsi_schedule(dp)
    with torch.no_grad():
        out = solver.solve(x0=x0, rhos=rhos, lams=sigmas, max_iter=24)
    got = metrics.mpsnr(_hwc(out.real), _hwc(gt))
    assert got == pytest.approx(JAX_CPU[f"hsi_{task}"], abs=0.01)
    assert got == pytest.approx(HSI_GOLDEN[task], abs=0.2)


def test_mid_grunet_beats_tiny():
    """tests/paper/test_hsi_grid.py::test_mid_grunet_fidelity_beats_tiny:
    denoising the cube plus 0.03 noise."""
    gt, _ = cs.synthetic_hsi()
    noisy = gt + 0.03 * np.random.RandomState(3).randn(*gt.shape).astype(np.float32)
    scores = {}
    for kind in ("tiny_grunet", "mid_grunet"):
        with torch.no_grad():
            out = get_denoiser(kind).denoise(torch.from_numpy(noisy), torch.tensor([0.03]))
        scores[kind] = metrics.mpsnr(_hwc(out), _hwc(gt))
        assert scores[kind] == pytest.approx(JAX_CPU[f"denoise_{kind}"], abs=0.01)
    assert scores["mid_grunet"] > scores["tiny_grunet"], scores


@pytest.fixture(scope="module")
def derain():
    solver, _, prior = cs.derain_pipeline(dp, "cpu")
    return solver, cs.derain_weights(prior, "cpu")


@pytest.mark.parametrize("crop_idx,rainy_psnr,expected", DERAIN_GOLDEN)
def test_derain_golden(derain, crop_idx, rainy_psnr, expected):
    """The shipped jointly-trained pipeline on the held-out crop; the
    pinned rainy input is the JAX package's synthetic_rain of that crop."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_derain as T

    gt, rainy = cs.derain_crops()[crop_idx]
    np.testing.assert_array_equal(gt[0], T.hopper_crops()[crop_idx])
    np.testing.assert_array_equal(
        rainy, np.asarray(T.synthetic_rain(jnp.asarray(gt), jax.random.key(500 + crop_idx))))
    solver, p = derain
    with torch.no_grad():
        out = cs.derain_solve(solver, p, torch.from_numpy(rainy))
    p_in = metrics.psnr(torch.from_numpy(rainy), torch.from_numpy(gt))
    p_out = metrics.psnr(torch.clamp(out, 0, 1), torch.from_numpy(gt))
    assert p_in == pytest.approx(rainy_psnr, abs=0.1)
    assert p_out == pytest.approx(JAX_CPU[f"derain_{crop_idx}"], abs=0.01)
    assert p_out == pytest.approx(expected, abs=0.15)
    assert p_out - p_in >= 8.0


def test_derain_training_gradients_match_jax():
    """tests/test_training.py::test_derain_joint_training_step on the
    synthetic face's 32x32 crop, with the same random params (nothing at
    zero) in both packages: loss and d loss / d (deg_op, dgu, rhos)."""
    img = cs._synthetic_face32()
    rainy = np.clip(img + 0.1, 0, 1)
    jdeg = JaxDegOp(max_step=1)
    deg_p = {n: _flax_params(m, jnp.zeros((1, 8, 8, 3)), seed=30 + i)
             for i, (n, m) in enumerate(jdeg.modules.items())}
    jnet = JaxDGU(**DGU_KW)
    dgu_p = _flax_params(jnet, jnp.zeros((1, 32, 32, 3)), seed=40)
    x = jdp.Variable()
    data = jdp.sum_squares(jdeg.as_linop(x), b=jdp.Placeholder("rainy"))
    prior = jdp.unrolled_prior(x, jnet, max_step=3, param_key="dgu")
    solver = jdp.compile([data, prior], method="pgd")
    params0 = {"deg_op": jax.tree.map(jnp.asarray, deg_p), "dgu": jax.tree.map(jnp.asarray, dgu_p),
               "rhos": jnp.full((3,), 0.5), "lams": jnp.full((3,), 0.1)}

    def loss_fn(p):
        out = solver.solve(x0=jnp.asarray(rainy), max_iter=3, rhos=p["rhos"], lams=p["lams"],
                           params={"rainy": jnp.asarray(rainy), "deg_op": p["deg_op"],
                                   "dgu": p["dgu"]})
        return jnp.mean((out - img) ** 2)

    loss, g = jax.value_and_grad(loss_fn)(params0)
    keys = DGUDenoiser(**DGU_KW).state_dict().keys()
    tp = {"deg_op": ck.deg_op_state_dict_from_flax(deg_p),
          "dgu": ck.dgu_state_dict_from_flax(dgu_p, keys),
          "rhos": torch.full((3,), 0.5), "lams": torch.full((3,), 0.1)}
    tloss, tg = cs.derain_train_grads(dp, "cpu", tp, img, rainy)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    ref = {("deg_op", n, k): v for n, sd in ck.deg_op_state_dict_from_flax(
        jax.tree.map(np.asarray, g["deg_op"])).items() for k, v in sd.items()}
    ref.update({("dgu", k): v for k, v in ck.dgu_state_dict_from_flax(
        jax.tree.map(np.asarray, g["dgu"]), keys).items()})
    ref[("rhos",)] = torch.from_numpy(np.asarray(g["rhos"]))
    assert set(ref) == set(tg)
    for group in ("deg_op", "dgu", "rhos"):
        ks = [k for k in ref if k[0] == group]
        want = torch.cat([ref[k].reshape(-1) for k in ks]).double()
        got = torch.cat([tg[k].reshape(-1) for k in ks]).double()
        assert float(want.abs().max()) > 0, group
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4, group


def test_unrolled_prior_pgd():
    """tests/test_pnp.py::test_unrolled_prior_pgd with random DGU weights
    (through param_key): the trajectory (return_full_states), the solution,
    and a second solve equal to the first (the carry resets at step 0)."""
    img = cs._synthetic_face32()
    psf = point_spread_function(5, 2)
    b = cs.blur64(img, psf)
    jnet = JaxDGU(**DGU_KW)
    p = _flax_params(jnet, jnp.zeros((1, 32, 32, 3)), seed=50)

    def build(pkg, net, **kw):
        x = pkg.Variable()
        data = pkg.sum_squares(pkg.conv(x, psf) - (torch.from_numpy(b) if pkg is dp else b))
        reg = pkg.unrolled_prior(x, net, max_step=3, param_key="dgu")
        return pkg.compile([data, reg], method="pgd", **kw)

    jsolver = build(jdp, jnet)
    net = DGUDenoiser(**DGU_KW)
    tsolver = build(dp, net, device="cpu")
    assert tsolver._has_stateful() and jsolver._has_stateful()
    jp = {"dgu": jax.tree.map(jnp.asarray, p)}
    tp = {"dgu": ck.dgu_state_dict_from_flax(p, net.state_dict().keys())}
    jtraj = jsolver.solve(x0=jnp.asarray(b), max_iter=3, rhos=0.5, lams=0.1, params=jp,
                          return_full_states=True)
    with torch.no_grad():
        ttraj = tsolver.solve(x0=torch.from_numpy(b), max_iter=3, rhos=0.5, lams=0.1,
                              params=tp, return_full_states=True)
        out1 = tsolver.solve(x0=torch.from_numpy(b), max_iter=3, rhos=0.5, lams=0.1, params=tp)
        out2 = tsolver.solve(x0=torch.from_numpy(b), max_iter=3, rhos=0.5, lams=0.1, params=tp)
    assert tuple(ttraj[0].shape) == (3, 1, 3, 32, 32)
    _close(ttraj[0], jtraj[0])
    assert torch.equal(out1, out2)
    _close(out1, jtraj[0][-1])


def test_ensemble_tv_registry_kind():
    """tests/test_pnp.py::test_ensemble_tv_registry_kind, against JAX."""
    x = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    ref = jax_get_denoiser("ensemble_tv").denoise(jnp.asarray(x), 0.05)
    with torch.no_grad():
        out = get_denoiser("ensemble_tv").denoise(torch.from_numpy(x), torch.tensor([0.05]))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    _close(out, ref)


def test_nlm_prior():
    """tests/test_pnp.py::test_nlm_prior (3 ADMM iterations with patch_nlm on
    the face crop plus noise), numpy noise in both packages."""
    img = cs._synthetic_face32()
    noisy = img + 0.05 * np.random.RandomState(0).randn(*img.shape).astype(np.float32)

    def build(pkg, **kw):
        x = pkg.Variable()
        data = pkg.sum_squares(x, b=pkg.utils.array(noisy))
        return pkg.compile([data, pkg.patch_nlm(x)], method="admm", **kw)

    ref = build(jdp).solve(x0=jnp.asarray(noisy), max_iter=3, rhos=1.0, lams=0.01)
    with torch.no_grad():
        out = build(dp, device="cpu").solve(x0=torch.from_numpy(noisy), max_iter=3, rhos=1.0,
                                            lams=0.01)
    assert bool(torch.isfinite(out).all())
    _close(out, ref)

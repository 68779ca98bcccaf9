"""The DOE co-design application (contrib.optic) in the port, on the CPU,
against the JAX package on the same numpy inputs.

Tolerances, each relative to the largest magnitude of the JAX value
unless a test says otherwise: the PSF, the convolutions, the phase
profiles, the resizes and the losses 1e-5 (float32 FFTs of the same
values; measured <= 2.8e-6); gradients (the PSF's, the hybrid PSF's, the
bilevel step's, the joint optic's through its unrolled CG) 1e-4 (measured
<= 2.6e-6, 1.9e-6 and 8.3e-6). The DOE_GOLDEN PSNRs: 0.01 dB of the JAX
package's (pinned from ``scripts/smoke_references.py optic``; measured
gaps <= 1.6e-6 dB), and the co-design at least 6 dB above the Fresnel
baseline, as tests/test_optics.py asks.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.contrib import optic as jo
from dprox_tpu_torch.contrib import optic as to
from dprox_tpu_torch.utils import checkpoint as ck
from dprox_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))  # train_doe
import chip_smoke as cs  # noqa: E402

WEIGHTS = os.path.join(ROOT, "weights", "doe_codesign.msgpack")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the test workers share the
    CPU (as in the LP test files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(pkg, patch=32, wave=64, **kw):
    """tests/test_optics.py::small_config in ``pkg`` (jo or to)."""
    return pkg.DOEModelConfig(patch_size=patch, wave_resolution=(wave, wave),
                              sample_interval=2e-6 * 1496 / wave, **kw)


def _models(patch=32, wave=64, **kw):
    return (jo.build_doe_model(_small(jo, patch, wave, **kw)),
            to.build_doe_model(_small(to, patch, wave, **kw), device="cpu"))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    dtype = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref) else np.float64
    got, ref = got.astype(dtype), ref.astype(dtype)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_configs_match_jax():
    """The reference optic (patch 748, 1496^2 wave grid, 2 um, 15 mm) and
    the hybrid one (patch 512, 1536^2) by default, as in the JAX package."""
    assert dataclasses.asdict(to.DOEModelConfig()) == dataclasses.asdict(jo.DOEModelConfig())
    assert (dataclasses.asdict(to.HybridDOEModelConfig())
            == dataclasses.asdict(jo.HybridDOEModelConfig()))
    cfg = to.DOEModelConfig()
    assert (cfg.patch_size, cfg.wave_resolution, cfg.sample_interval, cfg.sensor_distance) == (
        748, (1496, 1496), 2e-6, 15e-3)


def test_entry_points_default_to_cuda(monkeypatch):
    """build_doe_model and build_hybrid_doe_model run on the card unless
    the caller asks for the CPU: without a GPU they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to.build_doe_model(_small(to))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to.build_hybrid_doe_model(to.HybridDOEModelConfig(patch_size=32,
                                                          wave_resolution=(64, 64)))


def test_psf_simulation():
    """tests/test_optics.py::test_psf_simulation in the port, and the PSF
    against JAX's; the constants made on the host (the Fresnel lens, H,
    the aperture) are the JAX package's bits."""
    jm, tm = _models()
    jp, tp = jm.init_params(), tm.init_params()
    assert np.array_equal(np.asarray(jp["height_map_sqrt"]), tp["height_map_sqrt"].numpy())
    assert np.array_equal(jm.propagator.H, tm.propagator.H.numpy())
    assert np.array_equal(jm.aperture, tm.aperture.numpy())
    psf = tm.get_psf(tp)
    assert psf.shape == (1, 3, 32, 32) and psf.dtype == torch.float32
    assert np.isclose(float(psf.sum()), 1.0, atol=1e-5)
    assert (psf.numpy() >= 0).all()
    assert _rel(psf.numpy(), jm.get_psf(jp)) <= 1e-5


def test_baseline_profile():
    """tests/test_optics.py::test_baseline_profile: unit modulus; the
    profile complex64 and equal to JAX's within 1e-5."""
    jm, tm = _models()
    prof = to.build_baseline_profile(tm)
    assert prof.shape == (1, 3, 64, 64) and prof.dtype == torch.complex64
    assert np.allclose(np.abs(prof.numpy()), 1.0, atol=1e-5)
    assert np.array_equal(to.build_baseline_height_map_sqrt(tm),
                          jo.build_baseline_height_map_sqrt(jm))
    assert _rel(prof.numpy(), jo.build_baseline_profile(jm)) <= 1e-5
    with pytest.raises(TypeError, match="must be real"):
        tm.get_psf({"height_map_sqrt": prof})


@pytest.mark.parametrize("circular", [True, False])
def test_img_psf_conv(circular):
    """tests/test_optics.py::test_img_psf_conv_linear_and_circular, and each
    mode against JAX (odd and even sizes for the linear mode's pads)."""
    rng = np.random.RandomState(0)
    for h, w in ((32, 32), (33, 30)):
        img = rng.rand(1, 3, h, w).astype(np.float32)
        psf = rng.rand(1, 3, 5, 5).astype(np.float32)
        psf /= psf.sum()
        got = to.img_psf_conv(torch.from_numpy(img), torch.from_numpy(psf), circular=circular)
        assert got.shape == img.shape
        ref = jo.img_psf_conv(jnp.asarray(img), jnp.asarray(psf), circular=circular)
        assert _rel(got.numpy(), ref) <= 1e-5


def test_forward_returns_the_image_through_the_optic_and_its_psf():
    jm, tm = _models()
    img = np.random.RandomState(1).rand(1, 3, 32, 32).astype(np.float32)
    out, psf = tm(torch.from_numpy(img), tm.init_params())
    ref_out, ref_psf = jm(jnp.asarray(img), jm.init_params())
    assert _rel(out.numpy(), ref_out) <= 1e-5 and _rel(psf.numpy(), ref_psf) <= 1e-5


def test_get_psf_gradient_matches_jax_grad():
    """d <psf, w> / d height_map_sqrt against jax.grad (1e-4), zero where
    the aperture zeroes the field in both packages."""
    jm, tm = _models()
    w = np.random.RandomState(2).rand(1, 3, 32, 32).astype(np.float32)
    h0 = np.asarray(jm.init_params()["height_map_sqrt"])
    ref = np.asarray(jax.grad(lambda h: jnp.sum(jm.get_psf({"height_map_sqrt": h}) * w))(
        jnp.asarray(h0)))
    h = torch.from_numpy(h0.copy()).requires_grad_(True)
    (tm.get_psf({"height_map_sqrt": h}) * torch.from_numpy(w)).sum().backward()
    got = h.grad.numpy()
    assert _rel(got, ref) <= 1e-4
    outside = tm.aperture.numpy() == 0
    assert outside.any()
    assert not got[outside].any() and not ref[outside].any()


def test_hybrid_psf_and_gradient_match_jax():
    """The hybrid model (Sellmeier indices, half-circular aperture, the lens
    phase under the DOE's, the + 1e-7 inside the square) at patch 32 on a
    64^2 grid (its default sampling scaled): the PSF 1e-5, its gradient
    1e-4."""
    kw = dict(patch_size=32, wave_resolution=(64, 64), sample_interval=5.4e-6 * 1536 / 64)
    jm = jo.build_hybrid_doe_model(jo.HybridDOEModelConfig(**kw))
    tm = to.build_hybrid_doe_model(to.HybridDOEModelConfig(**kw), device="cpu")
    assert np.array_equal(to.sellmeier_fused_silica(kw["sample_interval"] * np.ones(3)),
                          jo.sellmeier_fused_silica(kw["sample_interval"] * np.ones(3)))
    assert np.array_equal(jm.aperture, tm.aperture.numpy())
    assert np.array_equal(jm.refractive_len, tm.refractive_len.numpy())
    h0 = np.asarray(jm.init_params()["height_map_sqrt"])
    w = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    ref_psf = jm.get_psf({"height_map_sqrt": jnp.asarray(h0)})
    ref = np.asarray(jax.grad(lambda h: jnp.sum(jm.get_psf({"height_map_sqrt": h}) * w))(
        jnp.asarray(h0)))
    h = torch.from_numpy(h0.copy()).requires_grad_(True)
    psf = tm.get_psf({"height_map_sqrt": h})
    assert np.isclose(float(psf.detach().sum()), 1.0, atol=1e-5)
    assert _rel(psf.detach().numpy(), ref_psf) <= 1e-5
    (psf * torch.from_numpy(w)).sum().backward()
    assert _rel(h.grad.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("shape,new", [((1, 3, 40, 52), (1, 3, 80, 104)),
                                       ((1, 3, 40, 52), (1, 3, 17, 23)),
                                       ((48, 36, 3), (20, 70, 3))])
def test_resize_cubic_matches_jax_image_resize(shape, new):
    """utils.imaging.resize_cubic against jax.image.resize(..., "cubic"):
    up by 2, down by ~2.3 (the antialiased kernel), and down on one axis,
    up on the other of an HWC array (1e-5)."""
    from dprox_tpu_torch.utils.imaging import resize_cubic

    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    got = resize_cubic(torch.from_numpy(x), new)
    assert tuple(got.shape) == new
    assert _rel(got.numpy(), jax.image.resize(jnp.asarray(x), new, "cubic")) <= 1e-5


def test_load_sample_img_and_sanity_check():
    """load_sample_img (the face cubic-resized to the patch) against JAX's,
    and sanity_check in both modes: conv_doe equals img_psf_conv, and its
    adjoint passes the dot-product test."""
    got = to.load_sample_img(patch_size=64, device="cpu")
    assert got.shape == (1, 3, 64, 64)
    assert _rel(got.numpy(), jo.load_sample_img(patch_size=64)) <= 1e-5
    _, tm = _models()
    psf = tm.get_psf(tm.init_params())
    for circular in (True, False):
        ok, x, out = to.sanity_check(psf, circular=circular, patch_size=32, device="cpu")
        assert ok
        ref_ok, _, ref = jo.sanity_check(np.asarray(psf), circular=circular, patch_size=32)
        assert ref_ok and _rel(out.numpy(), ref) <= 1e-5


def test_bilevel_step_gradient_matches_jax():
    """tests/test_optics.py::test_bilevel_training_step in both packages:
    the PSF from the height map, the conv_doe data term, 3 admm iterations
    with nonneg (the fused ADMM update's plain version here), the loss and
    its gradient with respect to the height map (1e-4; measured ~1e-6)."""
    jm = jo.build_doe_model(_small(jo))
    gt = np.random.RandomState(0).rand(1, 3, 32, 32).astype(np.float32)
    h0 = np.asarray(jm.init_params()["height_map_sqrt"])

    x = jdp.Variable()
    jsolver = jdp.compile([jdp.sum_squares(jdp.conv_doe(x, jdp.Placeholder("psf"), circular=True),
                                           b=jdp.Placeholder("y")), jdp.nonneg(x)], method="admm")

    def jstep(h):
        psf = jm.get_psf({"height_map_sqrt": h})
        inp = jo.img_psf_conv(jnp.asarray(gt), psf, circular=True)
        out = jsolver.solve(x0=inp, max_iter=3, rhos=0.1, lams=0.05,
                            params={"psf": psf, "y": inp})
        return jnp.mean((out - gt) ** 2)

    ref_loss, ref_g = jax.value_and_grad(jstep)(jnp.asarray(h0))

    loss, grad = cs.bilevel_step(dp, "cpu", h0, gt)
    assert np.isfinite(float(loss)) and float(grad.abs().sum()) > 0
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert _rel(grad.numpy(), ref_g) <= 1e-4


def test_joint_optic_loss_and_gradient_match_jax():
    """examples/papers/e2e_optics_joint.py's step at patch 32 (2 admm
    iterations, mosaic(conv_doe), tv prior, the CG x-update unrolled for
    its gradient) on the face's crop and one numpy noise draw in both
    packages: the loss (1e-5) and its gradients with respect to the height
    map, rhos and sigmas (1e-4)."""
    from dprox_tpu.utils import imaging as jimaging
    from dprox_tpu_torch.utils.imaging import _synthetic_face

    patch, n = 32, 2
    gt = np.ascontiguousarray(_synthetic_face(512, 512)[:patch, :patch].transpose(2, 0, 1)[None])
    noise = np.random.RandomState(5).randn(1, 3, patch, patch).astype(np.float32)
    rhos, sigmas = (np.asarray(v) for v in jdp.log_descent(49, 7.65, n, sigma=7.65 / 255))
    jm = jo.build_doe_model(_small(jo, patch, 2 * patch))
    h0 = np.asarray(jm.init_params()["height_map_sqrt"])
    x = jdp.Variable()
    jsolver = jdp.compile(
        jdp.sum_squares(jdp.mosaic(jdp.conv_doe(x, jdp.Placeholder("psf"), circular=True)),
                        b=jdp.Placeholder("y")) + jdp.deep_prior(x, "tv"), method="admm",
        linear_solve_config=jdp.LinearSolveConfig(max_iters=10, use_analytic_grad=False))

    def jstep(p):
        psf = jm.get_psf({"height_map_sqrt": p[0]})
        inp = jimaging.mosaicing(jo.img_psf_conv(jnp.asarray(gt), psf, circular=True))
        inp = inp + 7.65 / 255 * noise
        out = jsolver.solve(x0=inp, rhos=p[1], lams=p[2], max_iter=n,
                            params={"psf": psf, "y": inp})
        return jnp.mean((out - gt) ** 2)

    ref_loss, ref_g = jax.value_and_grad(jstep)(
        (jnp.asarray(h0), jnp.asarray(rhos), jnp.asarray(sigmas)))
    loss, grads = cs.joint_optic_step(dp, "cpu", h0, rhos, sigmas, gt, noise, patch=patch,
                                      max_iter=n)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for got, ref in zip(grads, ref_g):
        assert _rel(got.numpy(), ref) <= 1e-4


def test_doe_checkpoint_loader():
    """load_doe_codesign reads weights/doe_codesign.msgpack by name, as
    flax.serialization.from_bytes does; doe_params_from_flax takes the JAX
    package's params as numpy arrays."""
    from flax import serialization

    import train_doe as T

    _, jmodel, _ = T.build()
    rhos0, sigmas0 = T.hand_schedule()
    template = {"height_map_sqrt": jmodel.init_params()["height_map_sqrt"], "rhos": rhos0,
                "sigmas": sigmas0}
    with open(WEIGHTS, "rb") as f:
        ref = serialization.from_bytes(template, f.read())
    got = ck.load_doe_codesign(WEIGHTS)
    assert sorted(got) == ["height_map_sqrt", "rhos", "sigmas"]
    for k in got:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k]))
    from_numpy = ck.doe_params_from_flax({k: np.asarray(v) for k, v in ref.items()})
    assert all(torch.equal(from_numpy[k], got[k]) for k in got)


@pytest.mark.parametrize("crop", sorted(cs.DOE_GOLDEN))
def test_trained_doe_codesign_golden(crop):
    """tests/test_optics.py::test_trained_doe_codesign in the port: the
    shipped optic and the Fresnel baseline reconstruct the pinned crop
    (scripts/train_doe.py's build and make_reconstruct, noise pinned from
    jax.random) within 0.01 dB of the JAX package's PSNRs, and the
    co-design at least 6 dB above the baseline."""
    from dprox_tpu_torch.contrib.optic import build_baseline_height_map_sqrt

    model, solver = cs.doe_build(dp, "cpu")
    crops, hand_rhos = cs.doe_crops()
    g, noise = (torch.from_numpy(a) for a in crops[crop])
    p = ck.load_doe_codesign(WEIGHTS)
    _, sigmas0 = dp.log_descent(80, 30, cs.DOE_ITERS)
    fresnel = torch.from_numpy(build_baseline_height_map_sqrt(model))
    with torch.no_grad():
        out_c = cs.doe_reconstruct(model, solver, p["height_map_sqrt"], g, p["rhos"],
                                   p["sigmas"], noise)
        out_f = cs.doe_reconstruct(model, solver, fresnel, g, torch.from_numpy(hand_rhos),
                                   sigmas0, noise)
    pc = metrics.psnr(torch.clamp(out_c, 0, 1), g)
    pf = metrics.psnr(torch.clamp(out_f, 0, 1), g)
    ref = cs.JAX_CPU_OPTIC[crop]
    assert abs(pc - ref["codesign"]) <= 0.01, (pc, ref)
    assert abs(pf - ref["fresnel"]) <= 0.01, (pf, ref)
    assert pc - pf >= cs.DOE_GAIN_DB, (pc, pf)
    expected, expected_fresnel = cs.DOE_GOLDEN[crop]
    assert abs(pc - expected) <= 0.15 and abs(pf - expected_fresnel) <= 0.15


def test_pinned_crops_and_noise_are_the_references():
    """tests/data/doe_golden_crops.npz holds train_doe.hopper_crops()'s
    crops 0 and 2, jax.random.normal(jax.random.key(100 + i)) at their
    shape and jnp.geomspace's float32 hand schedule (needs matplotlib and
    PIL, as hopper_crops does)."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    import train_doe as T

    crops, hand_rhos = cs.doe_crops()
    live = T.hopper_crops()
    assert sorted(crops) == [0, 2]
    for i, (g, noise) in crops.items():
        assert np.array_equal(g[0], live[i])
        assert np.array_equal(noise, np.asarray(jax.random.normal(jax.random.key(100 + i),
                                                                  g.shape)))
    assert np.array_equal(hand_rhos, np.asarray(T.hand_schedule()[0]))


def test_common_and_psf_utilities_match_jax(tmp_path):
    """get_one_phase_shift_thickness, center_crop, normalize_psf (global and
    per band), normalize_psf2 (per band and global) equal the JAX
    package's; the plots write their files."""
    import matplotlib

    matplotlib.use("Agg")
    assert np.array_equal(to.get_one_phase_shift_thickness([460e-9, 550e-9], 1.46),
                          jo.get_one_phase_shift_thickness([460e-9, 550e-9], 1.46))
    psf = np.random.RandomState(6).rand(20, 24, 3).astype(np.float32)
    assert np.array_equal(to.center_crop(psf, 10, 11), jo.center_crop(psf, 10, 11))
    for bandwise in (False, True):
        assert np.array_equal(to.normalize_psf(psf, bandwise=bandwise),
                              jo.normalize_psf(psf, bandwise=bandwise))
    for mode in ("band", "global"):
        assert np.array_equal(to.normalize_psf2(psf, mode=mode), jo.normalize_psf2(psf, mode=mode))
    chw = torch.from_numpy(psf.transpose(2, 0, 1)[None].copy())
    to.subplot(chw, str(tmp_path / "sub.png"))
    to.plot(chw[0, 0], str(tmp_path / "one.png"))
    to.plot3d(torch.rand(60, 60), str(tmp_path / "surf.png"), region=(5, 55))  # 50 x 50
    assert all((tmp_path / n).exists() for n in ("sub.png", "one.png", "surf.png"))


def test_datasets_match_jax(tmp_path):
    """SingleImageDataset and Dataset (resized to 20, down from 24 x 30)
    over a directory of images, against the JAX package's (1e-5)."""
    from PIL import Image

    rng = np.random.RandomState(7)
    for name in ("a.png", "b.png"):
        Image.fromarray((rng.rand(24, 30, 3) * 255).astype(np.uint8)).save(tmp_path / name)
    (tmp_path / "notes.txt").write_text("not an image")
    tds, jds = to.SingleImageDataset(str(tmp_path)), jo.SingleImageDataset(str(tmp_path))
    assert len(tds) == len(jds) == 2
    for i in range(2):
        (a, na), (b, nb) = tds[i], jds[i]
        assert na == nb and np.array_equal(a, b)
    tds, jds = to.Dataset(str(tmp_path), size=20), jo.Dataset(str(tmp_path), size=20)
    for i in range(2):
        assert tds[i].shape == (3, 20, 20) and _rel(tds[i], jds[i]) <= 1e-5

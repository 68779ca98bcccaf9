"""The FFDNet prior family of the port against the JAX package's.

Every wrapper of ``proxfn/pnp/denoisers.py`` runs on small random FFDNets
(nc 16, nb 4, JAX's own initialization) carried across by
``ffdnet_state_dict_from_flax``; every shipped kind of ``get_denoiser``
runs on a 64x64 input; the lam schedule forms and the 256^2 PnP gate of
tests/test_pnp.py run through whole solves.

Tolerances: float32 network outputs to atol 1e-4 (the two frameworks sum
the convolutions in different orders; nets in [0, 1]); bfloat16 outputs to
2**-6, two bf16 units in the last place at 1.0 (XLA-CPU and oneDNN round
bf16 convolutions' partial sums differently, so a pixel may land one unit
away on either side); 3-D TV and the solves to 1e-5; PSNRs to 0.02 dB.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.proxfn.pnp import denoisers as jden
from dprox_tpu.proxfn.pnp.prior import get_denoiser as jax_get_denoiser
from dprox_tpu.models.tv import tv_denoising3d_chw as jax_tv3d
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu.utils import metrics as jmetrics
from dprox_tpu_torch.models.tv import tv_denoising3d_chw
from dprox_tpu_torch.proxfn.pnp import denoisers as tden
from dprox_tpu_torch.proxfn.pnp.prior import PORTED_KINDS, get_denoiser
from dprox_tpu_torch.utils import metrics

F32_TOL = 1e-4
BF16_TOL = 2.0 ** -6


def _pair(jax_cls, torch_cls, seed, **kw):
    """The same random small FFDNet in both packages."""
    j = jax_cls(nc=16, nb=4, residual=True, **kw)
    in_nc = 3 if jax_cls is jden.FFDNetColorDenoiser else 1
    params = j.module.init(jax.random.key(seed), jnp.zeros((1, 32, 32, in_nc)), jnp.zeros(()))
    j = jax_cls(params=params, nc=16, nb=4, residual=True, **kw)
    t = torch_cls(params=jax.tree.map(np.asarray, params), nc=16, nb=4, residual=True, **kw)
    return j, t


@pytest.fixture(scope="module")
def nets():
    color = _pair(jden.FFDNetColorDenoiser, tden.FFDNetColorDenoiser, 1)
    gray = _pair(jden.FFDNetDenoiser, tden.FFDNetDenoiser, 2)
    return {"color": color, "gray": gray}


def _denoise_both(j, t, x, sigma):
    ref = np.asarray(j.denoise(jnp.asarray(x), jnp.asarray(sigma)))
    with torch.no_grad():
        got = t.denoise(torch.from_numpy(x), torch.from_numpy(sigma))
    return got, ref


def _wrap(name, j, t, nets):
    if name == "x8":
        return jden.Augment(j), tden.Augment(t)
    if name == "bf16":
        return jden.BF16Denoiser(j), tden.BF16Denoiser(t)
    if name == "ensemble":
        jg, tg = nets["gray"]
        return (jden.EnsembleDenoiser([j, jg], [0.7, 0.3]),
                tden.EnsembleDenoiser([t, tg], [0.7, 0.3]))
    if name == "deep_tv_x8":
        return (jden.Augment(jden.DeepTVDenoiser(j, weight=0.6)),
                tden.Augment(tden.DeepTVDenoiser(t, weight=0.6)))
    return j, t


@pytest.mark.parametrize("net", ["color", "gray"])
@pytest.mark.parametrize("wrapper", ["plain", "x8", "bf16", "ensemble", "deep_tv_x8"])
def test_wrapper_matches_jax(nets, net, wrapper):
    """Non-square 2x3x40x56 input: x8 hands the network and TV planes with
    H and W swapped; the gray net folds the three bands into the batch."""
    j, t = _wrap(wrapper, *nets[net], nets)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 3, 40, 56).astype(np.float32)
    got, ref = _denoise_both(j, t, x, np.array([0.05], np.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    tol = BF16_TOL if wrapper == "bf16" else F32_TOL
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


def test_bf16_leaves_the_wrapped_network_in_float32(nets):
    t = nets["color"][1]
    bf = tden.BF16Denoiser(t)
    assert all(p.dtype == torch.float32 for p in t.module.parameters())
    assert all(p.dtype == torch.bfloat16 for p in bf.denoiser.module.parameters())
    assert bf.receptive_radius == t.receptive_radius == 8


def test_receptive_radius_where_jax_sets_it(nets):
    (jc, tc), (jg, tg) = nets["color"], nets["gray"]
    pairs = [(jc, tc), (jg, tg), (jden.TVDenoiser(7), tden.TVDenoiser(7)),
             (jden.EnsembleDenoiser([jc, jden.TVDenoiser(20)]),
              tden.EnsembleDenoiser([tc, tden.TVDenoiser(20)])),
             (jden.Augment(jc), tden.Augment(tc))]
    for j, t in pairs:
        assert getattr(j, "receptive_radius", None) == t.receptive_radius


@pytest.mark.parametrize("lam", [0.05, 0.3])
def test_tv_denoising3d_matches_jax(lam):
    rng = np.random.RandomState(5)
    y = rng.rand(4, 24, 20).astype(np.float32)
    lam_np = np.array([lam], np.float32)
    ref = np.asarray(jax_tv3d(jnp.asarray(y), jnp.asarray(lam_np), 25))
    got = tv_denoising3d_chw(torch.from_numpy(y), torch.as_tensor(lam_np), 25)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_tv_denoiser_3d_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.rand(1, 5, 16, 24).astype(np.float32)
    got, ref = _denoise_both(jden.TVDenoiser(8, use_3dtv=True), tden.TVDenoiser(8, use_3dtv=True),
                             x, np.array([0.1], np.float32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


SHIPPED = [k for k in PORTED_KINDS if k not in ("ffdnet", "ffdnet_color")]


@pytest.mark.parametrize("kind", SHIPPED)
def test_shipped_kind_matches_jax(kind):
    rng = np.random.RandomState(7)
    x = rng.rand(1, 3, 64, 64).astype(np.float32)
    got, ref = _denoise_both(jax_get_denoiser(kind), get_denoiser(kind), x,
                             np.array([0.05], np.float32))
    tol = BF16_TOL if kind.endswith("bf16") else F32_TOL
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["ffdnet", "ffdnet_color"])
def test_kinds_without_weights_warn_and_run_untrained(kind):
    with pytest.warns(UserWarning, match="RANDOM-INITIALIZED"):
        den = get_denoiser(kind)
    x = torch.rand(1, 3, 16, 16)
    with torch.no_grad():
        out = den.denoise(x, torch.tensor([0.05]))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_deep_prior_default_is_ffdnet():
    with pytest.warns(UserWarning):
        fn = dp.deep_prior(dp.Variable())
    assert fn.name == "ffdnet" and isinstance(fn.denoiser, tden.FFDNetDenoiser)


def test_unknown_kind_lists_the_ported_ones():
    with pytest.raises(KeyError, match="distilled_color_tv_bf16"):
        get_denoiser("ensemble_tv")


def test_ssim_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(16, 16, 4).astype(np.float32)
    b = np.clip(a + 0.01 * rng.randn(16, 16, 4), 0, 1).astype(np.float32)
    c = rng.rand(1, 3, 20, 24).astype(np.float32)
    d = np.clip(c + 0.05 * rng.randn(*c.shape), 0, 1).astype(np.float32)
    for o, t in ((a, b), (c, d), (torch.from_numpy(c), torch.from_numpy(d))):
        ref = jmetrics.ssim(np.asarray(o), np.asarray(t))
        assert abs(metrics.ssim(o, t) - ref) <= 1e-6
    assert 0.5 < metrics.ssim(a, b) <= 1.0


# --------------------------------------------------------------------------- #
# Whole solves: the lam schedule forms, x8, and the 256^2 PnP gate
# --------------------------------------------------------------------------- #

def _deconv(size=48, width=64):
    img = np.asarray(jimaging.sample("face"))[:, :, :size, :width].copy()
    psf = jimaging.point_spread_function(15, 5)
    b = np.array(jimaging.blurring(jnp.asarray(img), psf))
    return img, psf, b


def _three_fns(pkg, psf, b):
    x = pkg.Variable()
    return [pkg.sum_squares(pkg.conv(x, psf) - b),
            pkg.norm1(pkg.grad(x, 0) + pkg.grad(x, 1)), pkg.nonneg(x)]


@pytest.mark.parametrize("form", ["dict", "list", "per_sample"])
def test_lam_forms_match_jax(form):
    """lams as a dict keyed by the fns (0.02 for the missing one), as one
    schedule per psi fn, and as [B, T] per-sample schedules."""
    img, psf, b = _deconv()
    T = 6
    b2 = np.concatenate([b, 0.9 * b], axis=0)
    fj, ft = _three_fns(jdp, psf, jnp.asarray(b2)), _three_fns(dp, psf, torch.from_numpy(b2))
    sched = np.linspace(0.02, 0.004, T).astype(np.float32)
    per_sample = np.stack([sched, 2 * sched])  # [B, T]

    def lams(fns):
        if form == "dict":
            return {fns[1]: sched}  # the nonneg block takes the 0.02 default
        if form == "list":
            return [sched, 0.5 * sched]
        return per_sample

    sj = jdp.compile(fj, "admm")
    st = dp.compile(ft, "admm", device="cpu")
    # the dict keys are the fns: they hash and compare by identity
    assert hash(ft[1]) == object.__hash__(ft[1]) and type(ft[1]).__eq__ is object.__eq__
    assert st.psi_fns[0] is ft[1]
    kw = dict(max_iter=T, rhos=per_sample if form == "per_sample" else 0.5)
    ref = np.asarray(sj.solve(x0=jnp.asarray(b2), lams=lams(fj), **kw))
    got = st.solve(x0=torch.from_numpy(b2), lams=lams(ft), **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    _, lam_list = st.defaults(kw["rhos"], lams(ft), T)
    if form == "dict":
        assert torch.all(lam_list[1] == 0.02)
    if form == "per_sample":
        assert tuple(lam_list[0].shape) == (T, 2)


def test_x8_solve_matches_jax():
    """deep_prior(x8=True) through a non-square solve (H and W swap under
    the rotations), 3 iterations of the flagship prior."""
    img, psf, b = _deconv(40, 56)
    rhos, sigmas = dp.log_descent(80, 25, 3)
    xj, xt = jdp.Variable(), dp.Variable()
    sj = jdp.compile([jdp.sum_squares(jdp.conv(xj, psf) - jnp.asarray(b)),
                      jdp.deep_prior(xj, "distilled_color_tv", x8=True)], "admm")
    st = dp.compile([dp.sum_squares(dp.conv(xt, psf) - torch.from_numpy(b)),
                     dp.deep_prior(xt, "distilled_color_tv", x8=True)], "admm", device="cpu")
    assert isinstance(st.psi_fns[0].denoiser, tden.Augment)
    ref = np.asarray(sj.solve(x0=jnp.asarray(b), max_iter=3, rhos=np.asarray(rhos),
                              lams=np.asarray(sigmas)))
    got = st.solve(x0=torch.from_numpy(b), max_iter=3, rhos=rhos, lams=sigmas)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)


@pytest.fixture(scope="module")
def hopper_256():
    import matplotlib
    from PIL import Image

    path = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                        "sample_data", "grace_hopper.jpg")
    img = np.asarray(Image.open(path), np.float32) / 255.0
    h, w = img.shape[:2]
    img = img[(h - 256) // 2:(h + 256) // 2,
              (w - 256) // 2:(w + 256) // 2].transpose(2, 0, 1)[None].copy()
    psf = jimaging.point_spread_function(15, 5)
    return img, psf, np.array(jimaging.blurring(jnp.asarray(img), psf))


def test_distilled_flagship_beats_predistillation_fusion(hopper_256):
    """tests/test_pnp.py::test_distilled_flagship_beats_predistillation_fusion
    in the port: the same pins, and each PSNR within 0.02 dB of the JAX
    package's on the same observation."""
    img, psf, b = hopper_256
    rhos, sigmas = dp.log_descent(80, 25, 24)

    def solve(prior):
        x = dp.Variable()
        bt = torch.from_numpy(b)
        s = dp.compile([dp.sum_squares(dp.conv(x, psf) - bt), dp.deep_prior(x, prior)],
                       "admm", device="cpu")
        with torch.no_grad():
            return metrics.psnr(s.solve(x0=bt, rhos=rhos, lams=sigmas, max_iter=24), img)

    def solve_jax(prior):
        x = jdp.Variable()
        bj = jnp.asarray(b)
        s = jdp.compile([jdp.sum_squares(jdp.conv(x, psf) - bj), jdp.deep_prior(x, prior)],
                        "admm")
        r, g = jdp.log_descent(80, 25, 24)
        return jmetrics.psnr(np.asarray(s.solve(x0=bj, rhos=r, lams=g, max_iter=24)), img)

    student = solve("distilled_color_tv")
    assert student == pytest.approx(33.57, abs=0.15), student
    baseline = solve("res_ffdnet_color_tv")
    assert baseline == pytest.approx(33.27, abs=0.15), baseline
    assert student > baseline, (student, baseline)
    assert abs(student - solve_jax("distilled_color_tv")) <= 0.02
    assert abs(baseline - solve_jax("res_ffdnet_color_tv")) <= 0.02

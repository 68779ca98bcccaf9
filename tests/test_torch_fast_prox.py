"""The port's fused fast proxes against the JAX package's on the CPU.

tests/test_fast_prox.py in torch: each fast prox's closed-form ``_solve``
(csmri, sisr, misr, compress_sensing, spi) and phase_ret's prox on the
same numpy inputs in both packages, their helpers (p2o, splits, upsample,
kron, the CDP operators, the centred FFTs), the HSI solves of
tests/paper/test_hsi_grid.py with the 3-D TV prior, the hyperspectral
metrics and ``downsampling`` against ``jax.image.resize``.

Tolerances: the float32 closed forms to 1e-5 of each output's largest
entry (the two CPU backends' FFTs and divisions round differently);
misr's per-pixel 8x8 solve to 1e-4 (two LAPACK paths); the HSI mPSNRs to
0.01 dB of JAX (24 iterations carry the rounding; measured <= 1.5e-5 dB)
and 0.2 dB of the goldens; ``spi_forward`` draws from its own generator,
so it is held to binary values and to the mean its Poisson rates give.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.proxfn.fast import pr as jpr
from dprox_tpu.proxfn.fast import sr as jsr
from dprox_tpu.proxfn.fast.spi import kron as jkron
from dprox_tpu.proxfn.fast.spi import spi_forward as jspi_forward
from dprox_tpu.proxfn.fast.spi import spi_inverse as jspi_inverse
from dprox_tpu.proxfn.pnp.denoisers import TVDenoiser as JTVDenoiser
from dprox_tpu.utils import fft as jfft
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu.utils import metrics as jmetrics
from dprox_tpu_torch.proxfn.fast import pr, sr
from dprox_tpu_torch.proxfn.fast.spi import kron, spi_forward, spi_inverse
from dprox_tpu_torch.proxfn.pnp.denoisers import TVDenoiser
from dprox_tpu_torch.utils import fft, imaging, metrics

REL = 1e-5


def _close(got, ref, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rel, err


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _solve_both(build, v, rho):
    """(port, JAX) outputs of ``build(pkg).solve([v], [rho])``."""
    got = build(dp).solve([_t(v)], torch.tensor([rho], dtype=torch.float32))
    ref = build(jdp).solve([jnp.asarray(v)], jnp.asarray([rho], jnp.float32))
    return got, ref


def test_csmri_solve_matches_jax_and_solves_its_subproblem():
    rng = np.random.RandomState(0)
    H = W = 16
    mask = (rng.rand(1, 1, H, W) > 0.5).astype(np.float32)
    gt = rng.rand(1, 1, H, W).astype(np.float32)
    y = np.asarray(jnp.asarray(mask) * jfft.fft2_center(jnp.asarray(gt)))
    v = rng.rand(1, 1, H, W).astype(np.float32)
    got, ref = _solve_both(
        lambda pkg: pkg.csmri(pkg.Variable(), pkg.utils.array(mask), pkg.utils.array(y)), v, 0.5)
    assert got.dtype == torch.complex64
    _close(got, ref)
    # optimality: M^H (M F x - y) + rho (F x - F v) = 0
    Fx = fft.fft2_center(got)
    m = _t(mask)
    grad = m * (m * Fx - _t(y)) + 0.5 * (Fx - fft.fft2_center(_t(v).to(torch.complex64)))
    assert float(grad.abs().max()) < 1e-4


def test_sisr_solve_matches_jax():
    rng = np.random.RandomState(1)
    k = rng.rand(1, 1, 5, 5).astype(np.float32)
    k /= k.sum()
    y = rng.rand(1, 1, 8, 8).astype(np.float32)
    v = rng.rand(1, 1, 16, 16).astype(np.float32)
    got, ref = _solve_both(
        lambda pkg: pkg.sisr(pkg.Variable(), pkg.utils.array(y), pkg.utils.array(k), 2), v, 0.3)
    assert got.dtype == torch.float32
    _close(got, ref)


def test_misr_solve_matches_jax():
    rng = np.random.RandomState(2)
    srf = rng.rand(8, 3).astype(np.float32)
    b = rng.rand(1, 3, 12, 12).astype(np.float32)
    v = rng.rand(1, 8, 12, 12).astype(np.float32)
    got, ref = _solve_both(lambda pkg: pkg.misr(pkg.Variable(), pkg.utils.array(b), srf), v, 0.7)
    _close(got, ref, 1e-4)


def test_compress_sensing_solve_matches_jax_and_solves_its_subproblem():
    rng = np.random.RandomState(2)
    mask = rng.rand(1, 4, 8, 8).astype(np.float32)
    gt = rng.rand(1, 4, 8, 8).astype(np.float32)
    y = np.sum(gt * mask, axis=1, keepdims=True)
    v = rng.rand(1, 4, 8, 8).astype(np.float32)
    got, ref = _solve_both(
        lambda pkg: pkg.compress_sensing(pkg.Variable(), pkg.utils.array(mask),
                                         pkg.utils.array(y)), v, 0.7)
    _close(got, ref)
    # optimality: A^T (A x - y) + rho (x - v) = 0
    m = _t(mask)
    grad = (torch.sum(got * m, 1, keepdim=True) - _t(y)) * m + 0.7 * (got - _t(v))
    assert float(grad.abs().max()) < 1e-4


def test_spi_solve_and_inverse_match_jax():
    rng = np.random.RandomState(3)
    ztilde = rng.rand(1, 1, 8, 8).astype(np.float32)
    K1 = (rng.rand(1, 1, 8, 8) * 16).astype(np.float32)
    K1[0, 0, 0, :3] = 0.0  # the K1 == 0 branch
    got = spi_inverse(_t(ztilde), _t(K1), 4.0, 1.0)
    ref = jspi_inverse(jnp.asarray(ztilde), jnp.asarray(K1), 4.0, 1.0)
    _close(got, ref)
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    y = (rng.rand(1, 1, 8, 8) > 0.5).astype(np.float32)
    got, ref = _solve_both(lambda pkg: pkg.spi(pkg.Variable(), 4, pkg.utils.array(y)),
                           ztilde, 1.5)
    _close(got, ref)


def test_spi_forward_is_binary_at_its_poisson_rate():
    """Different generators: held to binary values and to the mean of
    P(count >= 1) = 1 - exp(-alpha x / K^2) over the K-fold upsampled grid,
    within five standard errors."""
    rng = np.random.RandomState(3)
    x = rng.rand(1, 1, 32, 32).astype(np.float32)
    K = 4
    ob = spi_forward(_t(x), K, alpha=K, q=1, generator=torch.Generator().manual_seed(0))
    ref = jspi_forward(jnp.asarray(x), K, alpha=K, q=1, key=jax.random.key(0))
    assert tuple(ob.shape) == ref.shape == (1, 1, 128, 128)
    assert set(np.unique(ob.numpy())) <= {0.0, 1.0}
    p = 1 - np.exp(-K * np.kron(x, np.ones((1, 1, K, K))) / K ** 2)
    se = np.sqrt((p * (1 - p)).sum()) / p.size
    assert abs(float(ob.mean()) - p.mean()) < 5 * se
    assert abs(float(np.asarray(ref).mean()) - p.mean()) < 5 * se


def test_phase_ret_prox_and_cdp_operators_match_jax():
    rng = np.random.RandomState(4)
    mask = ((rng.rand(1, 2, 8, 8) > 0.5) * 2.0 - 1.0).astype(np.complex64)
    gt = rng.rand(1, 1, 8, 8).astype(np.complex64)
    y0 = np.abs(np.asarray(jpr.cdp_forward(jnp.asarray(gt), jnp.asarray(mask)))).astype(np.float32)
    _close(pr.cdp_forward(_t(gt), _t(mask)), jpr.cdp_forward(jnp.asarray(gt), jnp.asarray(mask)))
    field = np.asarray(jpr.cdp_forward(jnp.asarray(gt), jnp.asarray(mask)))
    _close(pr.cdp_backward(_t(field), _t(mask)),
           jpr.cdp_backward(jnp.asarray(field), jnp.asarray(mask)))
    v = rng.rand(1, 1, 8, 8).astype(np.float32)
    for steps in (1, 3):
        got = dp.phase_ret(dp.Variable(), dp.utils.array(mask), dp.utils.array(y0),
                           steps=steps)._prox(_t(v), torch.tensor(0.5))
        ref = jdp.phase_ret(jdp.Variable(), jdp.utils.array(mask), jdp.utils.array(y0),
                            steps=steps)._prox(jnp.asarray(v), jnp.asarray(0.5))
        _close(got, ref)


@pytest.mark.parametrize("sf", [2, 3])
def test_sr_helpers_match_jax(sf):
    rng = np.random.RandomState(5)
    a = rng.rand(2, 3, 6 * sf, 4 * sf).astype(np.float32)
    assert np.array_equal(sr.splits(_t(a), sf).numpy(), np.asarray(jsr.splits(jnp.asarray(a), sf)))
    x = rng.rand(1, 2, 5, 7).astype(np.float32)
    assert np.array_equal(sr.upsample(_t(x), sf).numpy(), np.asarray(jsr.upsample(jnp.asarray(x), sf)))
    k = rng.rand(1, 1, 5, 5).astype(np.float32)
    _close(sr.p2o(_t(k), (12, 14)), jsr.p2o(jnp.asarray(k), (12, 14)))
    b = rng.rand(1, 1, sf, sf).astype(np.float32)
    assert np.array_equal(kron(_t(x), _t(b)).numpy(),
                          np.asarray(jkron(jnp.asarray(x), jnp.asarray(b))))


def test_centred_ffts_and_traced_otf_match_jax():
    rng = np.random.RandomState(6)
    x = (rng.rand(2, 1, 12, 10) + 1j * rng.rand(2, 1, 12, 10)).astype(np.complex64)
    _close(fft.fft2_center(_t(x)), jfft.fft2_center(jnp.asarray(x)))
    _close(fft.ifft2_center(_t(x)), jfft.ifft2_center(jnp.asarray(x)))
    _close(fft.ifft2_center(fft.fft2_center(_t(x))), x)
    psf = rng.rand(1, 3, 5, 5).astype(np.float32)
    for hw in ((16, 16), (15, 18)):
        for shift in (True, False):
            _close(fft.psf2otf_traced(_t(psf), hw, shift),
                   jfft.psf2otf_traced(jnp.asarray(psf), hw, shift))


@pytest.mark.parametrize("sf", [2, 3])
def test_downsampling_matches_jax_image_resize(sf):
    """The cubic x0 is jax.image.resize's Keys kernel (a = -0.5, borders
    renormalised), not F.interpolate's bicubic (a = -0.75, clamped)."""
    img = jimaging._synthetic_face(512, 512)[:48, :48].transpose(2, 0, 1)[None].copy()
    psf = jimaging.point_spread_function(7, 2)
    y_ref, x0_ref = jimaging.downsampling(jnp.asarray(img), psf, sf)
    y, x0 = imaging.downsampling(_t(img), psf, sf)
    _close(y, y_ref)
    _close(x0, x0_ref)
    bicubic = torch.nn.functional.interpolate(y, scale_factor=sf, mode="bicubic")
    assert float((bicubic - x0).abs().max()) > 1e-3  # a different function


def test_hyperspectral_metrics_match_jax():
    rng = np.random.RandomState(7)
    gt = rng.rand(1, 8, 20, 24)
    out = np.clip(gt + 0.05 * rng.randn(*gt.shape), 0, 1)
    hwc = lambda a: np.transpose(a[0], (1, 2, 0))  # noqa: E731
    for name in ("sam", "ergas", "mpsnr", "mssim", "mpsnr_max"):
        got = getattr(metrics, name)(hwc(out), hwc(gt))
        assert got == pytest.approx(getattr(jmetrics, name)(hwc(out), hwc(gt)), rel=1e-12), name


def synthetic_hsi(bands=8, size=64):
    """examples/papers/hsi_suite.py::synthetic_hsi on the synthetic face
    (what imaging.sample("face") gives without scipy's dataset cache)."""
    rgb = jimaging._synthetic_face(512, 512).transpose(2, 0, 1)[:, :size, :size]
    ws = np.stack([np.abs([np.cos(0.2 * b), np.sin(0.15 * b) ** 2, 0.5 + 0.5 * np.cos(0.3 * b)])
                   for b in range(bands)])
    ws = ws / ws.sum(1, keepdims=True)
    return np.einsum("bc,chw->bhw", ws, rgb)[None].astype(np.float32), ws


def _hsi_task(pkg, name, gt, srf, sigma_n=0.05, iters=24):
    """tests/paper/test_hsi_grid.py::_task with the 3-D TV prior; both
    packages get the same numpy observation and x0."""
    B = gt.shape[1]

    def noisy(a):
        a = np.asarray(a)
        return (a + sigma_n * np.random.RandomState(5).randn(*a.shape)).astype(np.float32)

    x = pkg.Variable()
    tv = (JTVDenoiser if pkg is jdp else TVDenoiser)(iter_num=10, use_3dtv=True)
    reg = pkg.deep_prior(x, tv, sqrt=True)
    if name == "sisr":
        psf = jimaging.point_spread_function(7, 2)
        y, x0 = jimaging.downsampling(jnp.asarray(gt), psf, 2)
        kernel = np.transpose(psf, (2, 0, 1))[None]
        data = pkg.sisr(x, pkg.utils.array(noisy(y)), pkg.utils.array(kernel), 2)
        x0 = noisy(x0)
    elif name == "misr":
        b = noisy(np.einsum("ck,nkp->ncp", srf.T, gt.reshape(1, B, -1)).reshape(1, 3, 64, 64))
        data = pkg.misr(x, pkg.utils.array(b), srf)
        x0 = np.repeat(b.mean(1, keepdims=True), B, axis=1)
    else:
        mask = (np.random.RandomState(0).rand(1, B, 64, 64) > 0.5).astype(np.float32)
        y = noisy(np.sum(gt * mask, axis=1, keepdims=True))
        data = pkg.compress_sensing(x, pkg.utils.array(mask), pkg.utils.array(y))
        x0 = np.repeat(y / max(B // 2, 1), B, axis=1)
    kw = {} if pkg is jdp else {"device": "cpu"}
    solver = pkg.compile([data, reg], method="admm", **kw)
    rhos, sigmas = pkg.log_descent(35 + 300 * sigma_n, 10 + 200 * sigma_n, iters, sigma=sigma_n)
    x0 = jnp.asarray(x0) if pkg is jdp else _t(x0)
    out = np.asarray(solver.solve(x0=x0, rhos=rhos, lams=sigmas, max_iter=iters))
    return jmetrics.mpsnr(np.transpose(out[0], (1, 2, 0)), np.transpose(gt[0], (1, 2, 0)))


@pytest.mark.parametrize("name,golden", [("sisr", 26.70), ("misr", 31.92), ("cs", 30.21)])
def test_hsi_fast_prox_solves_match_jax(name, golden):
    gt, srf = synthetic_hsi()
    got = _hsi_task(dp, name, gt, srf)
    ref = _hsi_task(jdp, name, gt, srf)
    assert got == pytest.approx(ref, abs=0.01), (got, ref)
    assert got == pytest.approx(golden, abs=0.2), got


def test_sisr_color_problem_matches_jax():
    """examples/applications/super_resolution.py at a 64x64 crop: Problem
    over sisr with the res_ffdnet_color_tv prior, 12 iterations, the same
    numpy observation and x0 in both packages."""
    img = jimaging._synthetic_face(512, 512)[:64, :64].transpose(2, 0, 1)[None].copy()
    psf = jimaging.point_spread_function(15, 2)
    y, x0 = (np.asarray(a) for a in jimaging.downsampling(jnp.asarray(img), psf, 2))
    kernel = np.transpose(psf, (2, 0, 1))[None]
    outs = []
    for pkg, arr, kw in ((dp, _t, {"device": "cpu"}), (jdp, jnp.asarray, {})):
        x = pkg.Variable()
        prob = pkg.Problem(pkg.sisr(x, pkg.utils.array(y), pkg.utils.array(kernel), 2)
                           + pkg.deep_prior(x, "res_ffdnet_color_tv"))
        rhos, sigmas = pkg.log_descent(60, 20, 12)
        outs.append(np.asarray(prob.solve(method="admm", x0=arr(x0), rhos=rhos, lams=sigmas,
                                          max_iter=12, **kw)))
    got, ref = outs
    assert jmetrics.psnr(got, img) == pytest.approx(jmetrics.psnr(ref, img), abs=0.01)
    assert jmetrics.psnr(got, img) > jmetrics.psnr(x0, img)
    _close(got, ref, 1e-4)

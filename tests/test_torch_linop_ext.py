"""The rest of the CG slice in the port against the JAX package on the CPU.

tests/test_precond.py in torch (its four assertions), the operators
``conv_doe`` (circular and linear, a gradient to a Placeholder PSF),
``mul_color``, ``BlackBox`` and ``LinOpFactory``, the frequency x-update
with a complex divisor (tests/test_algorithms.py::
test_freq_xupdate_complex_diag_falls_back), the demosaicking and SR
initializations, and Pock-Chambolle with a fused fast prox.

Tolerances: operators to 1e-5 of the output's largest entry (two CPU
FFTs), adjoint identities to 1e-4 relative as in tests/test_linop.py,
the demosaicking inits bit for bit (the same float32 ops) except the
edge-aware one (OpenCV on the same 8-bit mosaic, bit for bit too), solves
to 1e-5, and test_precond.py's own bounds.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.linop import adjoint as jadjoint
from dprox_tpu.linop import eval as jeval
from dprox_tpu.utils import imaging as jimaging
from dprox_tpu.utils import init as jinit
from dprox_tpu_torch.linop import adjoint, eval as teval, validate
from dprox_tpu_torch.utils import imaging, init, metrics


tss = importlib.import_module("dprox_tpu_torch.proxfn.sum_squares")
jss = importlib.import_module("dprox_tpu.proxfn.sum_squares")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------- #
# tests/test_precond.py in torch
# ---------------------------------------------------------------------- #

def _jd_problem(solver_type="cg", max_iters=40, size=48):
    img = jimaging._synthetic_face(512, 512)[:size, :size].transpose(2, 0, 1)[None].copy()
    psf = imaging.point_spread_function(9, 2)
    b = imaging.mosaicing(imaging.blurring(_t(img), psf))
    x = dp.Variable()
    data = dp.sum_squares(dp.mosaic(dp.conv(x, psf)) - dp.Placeholder("b"))
    solver = dp.compile(data + dp.deep_prior(x, "tv"), method="admm", device="cpu",
                        linear_solve_config=dp.LinearSolveConfig(solver_type=solver_type,
                                                                 max_iters=max_iters))
    return img, b, solver


def test_surrogate_values():
    psf = imaging.point_spread_function(9, 2)
    x = dp.Variable()
    tree = dp.mosaic(dp.conv(x, psf)) - dp.Placeholder("b")
    shape = (1, 3, 32, 32)
    s = torch.real(torch.as_tensor(tree.gram_freq_surrogate(shape))).numpy()
    assert s.shape == (1, 3, 32, 32)
    np.testing.assert_allclose(s[0, :, 0, 0], [0.25, 0.5, 0.25], atol=1e-5)
    assert (s >= -1e-8).all()
    jx = jdp.Variable()
    ref = jdp.mosaic(jdp.conv(jx, psf)) - jdp.Placeholder("b")
    assert _rel(s, np.real(np.asarray(ref.gram_freq_surrogate(shape)))) <= 1e-5
    # an operator without a surrogate kills the tree's, as in the JAX package
    bb = dp.LinOpFactory(lambda v, p: v, lambda v, p: v)(x)
    assert bb.gram_freq_surrogate(shape) is None


def test_preconditioned_matches_unpreconditioned():
    img, b, fast = _jd_problem("cg", max_iters=60)
    _, _, slow = _jd_problem("cg2", max_iters=300)  # cg2 takes no preconditioner
    init_ = dp.utils.demosaic_from_mosaiced(b)
    rhos, sigmas = dp.log_descent(35, 10, 4)
    kw = dict(x0=init_, rhos=rhos, lams=sigmas, max_iter=4, params={"b": b})
    out_p, out_u = fast.solve(**kw).numpy(), slow.solve(**kw).numpy()
    assert np.abs(out_p - out_u).max() < 2e-2, np.abs(out_p - out_u).max()
    assert abs(metrics.psnr(out_p, img) - metrics.psnr(out_u, img)) < 0.05


def test_preconditioner_accelerates_inner_budget():
    img, b, ref_solver = _jd_problem("cg", max_iters=200)
    init_ = dp.utils.demosaic_from_mosaiced(b)
    rhos, sigmas = dp.log_descent(35, 10, 8)
    kw = dict(x0=init_, rhos=rhos, lams=sigmas, max_iter=8, params={"b": b})
    ref_psnr = metrics.psnr(ref_solver.solve(**kw), img)
    p10 = metrics.psnr(_jd_problem("cg", max_iters=10)[2].solve(**kw), img)
    u10 = metrics.psnr(_jd_problem("cg2", max_iters=10)[2].solve(**kw), img)
    assert p10 > ref_psnr - 0.1, (p10, ref_psnr)
    assert u10 < ref_psnr - 0.3, (u10, ref_psnr)


def test_gradients_flow_through_preconditioned_solve():
    img = jimaging._synthetic_face(512, 512)[:16, :16].transpose(2, 0, 1)[None].copy()
    psf = imaging.point_spread_function(5, 1.5)
    b0 = imaging.mosaicing(imaging.blurring(_t(img), psf))

    def grad(solver_type):
        b = b0.clone().requires_grad_()
        x = dp.Variable()
        data = dp.sum_squares(dp.mosaic(dp.conv(x, psf)) - dp.Placeholder("b"))
        s = dp.compile(data + dp.nonneg(x), method="admm", device="cpu",
                       linear_solve_config=dp.LinearSolveConfig(solver_type=solver_type,
                                                                max_iters=60))
        out = s.solve(x0=b, rhos=0.1, lams=0.05, max_iter=3, params={"b": b})
        (g,) = torch.autograd.grad(torch.sum(out ** 2), b)
        return g.numpy()

    np.testing.assert_allclose(grad("cg"), grad("cg2"), atol=2e-3, rtol=1e-2)


# ---------------------------------------------------------------------- #
# Operators
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("circular", [True, False])
def test_conv_doe_matches_jax_and_is_adjoint(circular):
    rng = np.random.RandomState(3)
    psf = rng.rand(1, 3, 5, 5).astype(np.float32)
    m = rng.rand(1, 3, 16, 16).astype(np.float32)
    d = rng.rand(1, 3, 16, 16).astype(np.float32)
    x, jx = dp.Variable(), jdp.Variable()
    op = dp.conv_doe(x, dp.Placeholder("psf"), circular=circular)
    jop = jdp.conv_doe(jx, jdp.Placeholder("psf"), circular=circular)
    params, jparams = {"psf": _t(psf)}, {"psf": psf}
    Km, Ktd = teval(op, _t(m), params), adjoint(op, _t(d), params)
    assert _rel(Km, jeval(jop, jnp.asarray(m), jparams)) <= 1e-5
    assert _rel(Ktd, jadjoint(jop, jnp.asarray(d), jparams)) <= 1e-5
    assert float(torch.sum(Km * _t(d))) == pytest.approx(float(torch.sum(_t(m) * Ktd)), rel=1e-4)
    assert op.is_diag(freq=True) is circular
    fixed = dp.conv_doe(dp.Variable(), psf[0], circular=circular)  # a fixed [C, h, w] PSF
    assert validate(fixed, shape=(1, 3, 16, 16))


def test_conv_doe_gradient_reaches_a_placeholder_psf():
    rng = np.random.RandomState(1)
    psf0 = rng.rand(1, 1, 3, 3).astype(np.float32)
    m = rng.rand(1, 1, 8, 8).astype(np.float32)
    op = dp.conv_doe(dp.Variable(), dp.Placeholder("psf"))
    psf = _t(psf0).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(teval(op, _t(m), {"psf": psf}) ** 2), psf)
    jop = jdp.conv_doe(jdp.Variable(), jdp.Placeholder("psf"))
    ref = jax.grad(lambda p: jnp.sum(jeval(jop, jnp.asarray(m), {"psf": p}) ** 2))(psf0)
    assert float(g.abs().sum()) > 0 and _rel(g, ref) <= 1e-5


def test_mul_color_matches_jax_and_is_adjoint():
    rng = np.random.RandomState(2)
    srf = rng.rand(8, 3).astype(np.float32)
    m = rng.rand(1, 8, 4, 4).astype(np.float32)
    d = rng.rand(1, 3, 4, 4).astype(np.float32)
    op, jop = dp.mul_color(dp.Variable(), srf), jdp.mul_color(jdp.Variable(), srf)
    Km, Ktd = teval(op, _t(m)), adjoint(op, _t(d))
    assert tuple(Km.shape) == (1, 3, 4, 4)
    assert _rel(Km, jeval(jop, jnp.asarray(m))) <= 1e-6
    assert _rel(Ktd, jadjoint(jop, jnp.asarray(d))) <= 1e-6
    assert float(torch.sum(Km * _t(d))) == pytest.approx(float(torch.sum(_t(m) * Ktd)), rel=1e-4)


def test_blackbox_reads_the_solver_step_and_is_adjoint():
    steps = []

    def fwd(v, params=None, step=None):
        steps.append(step)
        return torch.roll(v, 1, dims=-1)

    def adj(v, params=None, step=None):
        return torch.roll(v, -1, dims=-1)

    op = dp.BlackBox(dp.Variable(), fwd, adj)
    assert validate(op, shape=(1, 3, 8, 8))
    teval(op, torch.ones(1, 1, 4, 4), {"__step__": 7})
    assert steps[-1] == 7
    teval(op, torch.ones(1, 1, 4, 4))
    assert steps[-1] == 0
    assert not op.is_diag(freq=True) and op.gram_freq_surrogate((1, 1, 4, 4)) is None


def _freq_blackbox(pkg, otf, xp):
    """A circular convolution given as closures with a frequency diag."""
    fft, ifft = ((torch.fft.fft2, torch.fft.ifft2) if xp is torch
                 else (jnp.fft.fft2, jnp.fft.ifft2))
    fwd = lambda v, params=None, step=None: ifft(otf * fft(v)).real  # noqa: E731
    adj = lambda v, params=None, step=None: ifft(otf.conj() * fft(v)).real  # noqa: E731
    diag = lambda shape, params=None, step=None: otf  # noqa: E731
    return pkg.LinOpFactory(fwd, adj, diag=diag, freq_diag=True)


def test_linop_factory_frequency_diagonal_solve_matches_jax():
    rng = np.random.RandomState(4)
    psf = jimaging.point_spread_function(5, 1.5)
    otf = jimaging.psf2otf(np.asarray(psf).squeeze(), (16, 16)).astype(np.complex64)[None, None]
    b = rng.rand(1, 1, 16, 16).astype(np.float32)
    outs = []
    for pkg, xp, arr in ((dp, torch, _t), (jdp, jnp, jnp.asarray)):
        x = pkg.Variable()
        op = _freq_blackbox(pkg, arr(otf), xp)(x)
        kw = {"device": "cpu"} if pkg is dp else {}
        solver = pkg.compile([pkg.sum_squares(op - arr(b)), pkg.nonneg(x)], "admm", **kw)
        assert solver.least_square.freq_diagonalizable
        outs.append(np.asarray(solver.solve(x0=arr(b), max_iter=8, rhos=0.1, lams=0.02)))
    assert _rel(*outs) <= 1e-5


def test_freq_xupdate_with_a_complex_divisor_takes_the_full_complex_path(monkeypatch):
    """tests/test_algorithms.py::test_freq_xupdate_complex_diag_falls_back:
    a non-symmetric complex divisor keeps the full-complex pair (and the
    complex-divisor divide) even above the half-spectrum gate, and equals
    the JAX package's x-update."""
    rng = np.random.RandomState(7)
    sp = rng.rand(1, 1, 16, 16).astype(np.float32)
    diag = (rng.rand(1, 1, 16, 16) + 1j * rng.rand(1, 1, 16, 16)).astype(np.complex64) + 2.0
    rho = torch.zeros(())
    want = tss._freq_xupdate(_t(sp), None, _t(diag), rho, 1e-7)
    monkeypatch.setattr(tss, "_RFFT_MIN_PLANE", 1)
    monkeypatch.setattr(tss, "_MAP_MIN_PLANE", 1)
    got = tss._freq_xupdate(_t(sp), None, _t(diag), rho, 1e-7)
    assert got.dtype == torch.float32 and got.shape == want.shape == sp.shape
    assert float((got - want).abs().max()) <= 1e-6
    ref = jss._freq_xupdate(jnp.asarray(sp), None, jnp.asarray(diag), 1e-7)
    assert _rel(got, ref) <= 1e-5
    # a real divisor above the gate takes the half spectrum, as in JAX
    monkeypatch.setattr(jss, "_RFFT_MIN_PLANE", 1)
    monkeypatch.setattr(jss, "_MAP_MIN_PLANE", 1)
    rdiag = np.abs(diag) + 0.0
    half = tss._freq_xupdate(_t(sp), None, _t(rdiag.astype(np.float32)), rho, 1e-7)
    assert _rel(half, jss._freq_xupdate(jnp.asarray(sp), None, jnp.asarray(rdiag), 1e-7)) <= 1e-5


def test_divisor_keeps_a_complex_spectrum():
    rho = torch.tensor([0.5])
    diag, r = tss._divisor(torch.ones(1, 1, 4, 4, dtype=torch.complex64), 1.0, rho, False)
    assert diag.dtype == torch.complex64 and r.dtype == torch.float32
    diag, r = tss._divisor(torch.ones(1, 1, 4, 4, dtype=torch.complex64),
                           torch.ones((), dtype=torch.complex64), rho, False)
    assert diag.dtype == torch.complex64 and torch.equal(r, torch.zeros_like(rho))


# ---------------------------------------------------------------------- #
# Initializations
# ---------------------------------------------------------------------- #

def test_demosaic_inits_match_jax():
    rng = np.random.RandomState(5)
    mosaic = rng.rand(2, 3, 16, 20).astype(np.float32) * jimaging.bayer_mask((16, 20))
    assert np.array_equal(init.demosaic_ea(mosaic).numpy(), np.asarray(jinit.demosaic_ea(mosaic)))
    planes = rng.rand(2, 4, 8, 10).astype(np.float32)
    assert np.array_equal(init.demosaic_malvar(_t(planes)).numpy(),
                          np.asarray(jinit.demosaic_malvar(jnp.asarray(planes))))


def test_demosaic_ea_without_opencv_is_malvar(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    mosaic = np.random.RandomState(6).rand(1, 3, 8, 8).astype(np.float32)
    planes = np.stack([mosaic[:, 0, 0::2, 0::2], mosaic[:, 1, 0::2, 1::2],
                       mosaic[:, 1, 1::2, 0::2], mosaic[:, 2, 1::2, 1::2]], axis=1)
    assert torch.equal(init.demosaic_ea(mosaic), init.demosaic_malvar(_t(planes)))


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3)])
@pytest.mark.parametrize("sf,upper_left", [(2, True), (3, False), (4, True)])
def test_shift_pixel_matches_jax(shape, sf, upper_left):
    x = np.random.RandomState(8).rand(*shape).astype(np.float32)
    assert np.array_equal(init.shift_pixel(x, sf, upper_left).numpy(),
                          np.asarray(jinit.shift_pixel(x, sf, upper_left)))


# ---------------------------------------------------------------------- #
# Pock-Chambolle with a fused fast prox
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("method", ["pc", "hqs", "ladmm"])
def test_solvers_with_a_fused_fast_prox_match_jax(method):
    """PC's fused branch (and the other solvers' x-update) through
    compress_sensing's closed-form solve."""
    rng = np.random.RandomState(9)
    mask = (rng.rand(1, 4, 16, 16) > 0.5).astype(np.float32)
    gt = rng.rand(1, 4, 16, 16).astype(np.float32)
    y = np.sum(gt * mask, axis=1, keepdims=True)
    x0 = np.repeat(y / 2, 4, axis=1)
    outs = []
    for pkg, arr in ((dp, _t), (jdp, jnp.asarray)):
        x = pkg.Variable()
        fns = [pkg.compress_sensing(x, pkg.utils.array(mask), pkg.utils.array(y)),
               pkg.deep_prior(x, "tv")]
        kw = {"device": "cpu"} if pkg is dp else {}
        solver = pkg.compile(fns, method=method, **kw)
        assert isinstance(solver.least_square, pkg.ext_sum_squares)
        outs.append(np.asarray(solver.solve(x0=arr(x0), max_iter=6, rhos=0.5, lams=0.05)))
    assert _rel(*outs) <= 1e-5

"""Gradients through the port against jax.grad of the JAX package.

At ties: JAX's ``jnp.maximum`` / ``jnp.clip`` split the gradient evenly
where an input equals its bound; the port's proxes and the kernels'
plain versions use ``torch.maximum`` / ``torch.minimum``, which do the
same, so the gradients are equal exactly (the points are exact in
float32 and the derivatives are products of 1, 0.5 and signs).

Through a solve: the gradient of a 5-iteration unrolled ``admm`` solve
at 1x3x32x32 with respect to its ``rhos`` and ``lams`` schedules, as
tests/test_specialization.py takes it in the JAX package, with
``norm1(grad(x))`` (the x-update's divide and the fused soft-threshold
update) and with ``deep_prior(x, "tv")`` (the TV prior). Both packages
get the same numpy image and observation. Tolerance: relative 5e-5 of
each gradient's largest entry, for float32 FFT and TV rounding of two
CPU backends carried through five iterations and their backward.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.ops import pallas_kernels as jkernels
from dprox_tpu.proxfn.pnp.denoisers import Denoiser as JDenoiser
from dprox_tpu.proxfn.pnp.denoisers import DeepTVDenoiser as JDeepTV
from dprox_tpu.utils.misc import safe_sqrt as jsafe_sqrt
from dprox_tpu_torch.ops import kernels
from dprox_tpu_torch.proxfn.pnp.denoisers import DeepTVDenoiser, Denoiser
from dprox_tpu_torch.utils import imaging
from dprox_tpu_torch.utils.misc import safe_sqrt

SOLVE_RTOL = 5e-5


def _torch_grad(fn, *args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    grads = torch.autograd.grad(fn(*ts), ts, allow_unused=True)
    return [np.zeros_like(a) if g is None else g.numpy() for a, g in zip(args, grads)]


def _jax_grad(fn, *args):
    return [np.asarray(g) for g in jax.grad(fn, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))]


V = np.array([-1.0, 0.0, 0.5, 1.0], np.float32)  # ROADMAP's tie points, lam = 0.5
W = np.array([0.3, -1.7, 2.1, 0.9], np.float32)  # cotangent weights


@pytest.mark.parametrize("name", ["nonneg", "norm1"])
def test_prox_gradient_at_ties_equals_jax(name):
    lam = np.float32(0.5)
    fn_t = getattr(dp, name)(dp.Variable())
    fn_j = getattr(jdp, name)(jdp.Variable())
    got = _torch_grad(lambda v, l: (fn_t._prox(v, l) * torch.from_numpy(W)).sum(), V, lam)
    ref = _jax_grad(lambda v, l: (fn_j._prox(v, l) * W).sum(), V, lam)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    expect = {"nonneg": [0, 0.5, 1, 1], "norm1": [1, 0, 0.5, 1]}[name]
    np.testing.assert_array_equal(got[0], np.float32(expect) * W)


def test_prior_clip_gradient_at_ties_equals_jax():
    """deep_prior(clamp=True) clips to [0, 1] before the TV denoiser;
    pixels at 0 and 1 are ties."""
    rng = np.random.RandomState(0)
    v = rng.rand(1, 3, 8, 8).astype(np.float32)
    v[0, 0, 0, :3] = [0.0, 1.0, 0.5]
    v[0, 1, 2, :2] = [1.0, 0.0]
    w = rng.randn(*v.shape).astype(np.float32)
    lam = np.float32(0.05)
    fn_t = dp.deep_prior(dp.Variable(), "tv", clamp=True).to("cpu")
    fn_j = jdp.deep_prior(jdp.Variable(), "tv", clamp=True)
    got = _torch_grad(lambda a, l: (fn_t._prox(a, l) * torch.from_numpy(w)).sum(), v, lam)
    ref = _jax_grad(lambda a, l: (fn_j._prox(a, l) * w).sum(), v, lam)
    for g, r in zip(got, ref):  # float32 TV rounding of two backends
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * np.abs(r).max())


S0 = np.float32(0.1)  # the noise level of the fusion test


class _Scaled(Denoiser):
    """x * sigma / S0: the identity at sigma = S0, with d/dsigma != 0."""

    def denoise(self, x, sigma):
        return x * (sigma / float(S0))


class _JScaled(JDenoiser):
    def denoise(self, x, sigma, params=None):
        return x * (sigma / S0)


def test_deeptv_fusion_weight_gradient_at_tie_equals_jax():
    """At sigma = S0 the deep branch returns x, so num = sum((x - t)^2) and
    den = num + 1e-12, which is num in float32: w = 1.0 exactly, a tie of
    the clip to [0, 1]; dw/dsigma is not 0 there, so the tie's factor 0.5
    shows in the gradient with respect to sigma."""
    rng = np.random.RandomState(1)
    x = rng.rand(1, 3, 8, 8).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    sigma = np.array([S0], np.float32)
    port = DeepTVDenoiser(_Scaled(), tv_iter=5)
    ref_d = JDeepTV(_JScaled(), tv_iter=5)
    xt = torch.from_numpy(x)
    t = port.tv.denoise(xt, torch.from_numpy(sigma))
    assert float(torch.sum((xt - t) * (xt - t)) / (torch.sum((xt - t) ** 2) + 1e-12)) == 1.0
    got = _torch_grad(lambda a, s: (port.denoise(a, s) * torch.from_numpy(w)).sum(), x, sigma)
    ref = _jax_grad(lambda a, s: (ref_d.denoise(a, s) * w).sum(), x, sigma)
    for g, r in zip(got, ref):  # float32 TV rounding of two backends
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())


def test_safe_sqrt_gradient_at_tie_equals_jax():
    x = np.array([np.float32(1e-8), 0.0, 4.0, 1e-9], np.float32)
    got = _torch_grad(lambda a: safe_sqrt(a).sum(), x)
    ref = _jax_grad(lambda a: jsafe_sqrt(a).sum(), x)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0][0] != 0 and got[0][1] == 0


@pytest.mark.parametrize("kind", ["nonneg", "soft"])
def test_plain_fused_admm_update_gradient_at_ties_equals_jax(kind):
    """w = Kx + u hits 0 (nonneg's tie, soft's sign(0)) and +-lam (soft's
    ties); the cotangents of v and u' differ, so both paths count."""
    Kx = np.array([[-1.0, 0.0, 0.5, 1.0, -0.5, 0.25]], np.float32)
    u = np.array([[0.0, 0.0, 0.0, 0.0, 0.0, 0.25]], np.float32)
    lam = np.array([0.5], np.float32)
    gv = np.array([[0.3, -1.7, 2.1, 0.9, 1.3, -0.4]], np.float32)
    gu = np.array([[1.1, 0.6, -0.8, 0.2, -2.0, 0.7]], np.float32)

    def loss_t(a, b, l):
        v, un = kernels.fused_admm_update_plain(a, b, l, kind)
        return (v * torch.from_numpy(gv)).sum() + (un * torch.from_numpy(gu)).sum()

    def loss_j(a, b, l):
        v, un = jkernels.fused_admm_update(a, b, l, kind)
        return (v * gv).sum() + (un * gu).sum()

    got, ref = _torch_grad(loss_t, Kx, u, lam), _jax_grad(loss_j, Kx, u, lam)
    # the closed-form VJP of the kernel's autograd Function gives the same
    vjp = kernels.fused_admm_update_vjp(*(torch.from_numpy(a) for a in (gv, gu, Kx, u, lam)),
                                        kind)
    assert (vjp[2] is None) == (kind == "nonneg")
    for g in (got, [t.numpy() for t in vjp[:2]]):
        np.testing.assert_array_equal(g[0], ref[0])
        np.testing.assert_array_equal(g[1], ref[1])
    # lam's gradient is a float32 sum over the elements, in another order
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6, atol=0)
    if kind == "soft":
        np.testing.assert_allclose(vjp[2].numpy(), ref[2], rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def observation():
    img = imaging._synthetic_face(512, 512)[224:256, 224:256].transpose(2, 0, 1)[None]
    img = np.ascontiguousarray(img, np.float32)
    psf = imaging.point_spread_function(5, 2)
    from dprox_tpu_torch.utils.fft import psf2otf

    otf = psf2otf(np.asarray(psf).squeeze(), (32, 32))
    b = np.real(np.fft.ifft2(otf * np.fft.fft2(img.astype(np.float64)))).astype(np.float32)
    return img, psf, b


RHOS = np.float32([0.05, 0.04, 0.06, 0.05, 0.03])
LAMS = np.float32([0.01, 0.02, 0.015, 0.01, 0.012])


def _solve_grads_torch(observation, prior):
    img, psf, b = observation
    x = dp.Variable()
    bt = torch.from_numpy(b)
    reg = dp.norm1(dp.grad(x)) if prior == "norm1" else dp.deep_prior(x, "tv")
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - bt), reg], "admm", device="cpu")
    rhos = torch.tensor(RHOS, requires_grad=True)
    lams = torch.tensor(LAMS, requires_grad=True)
    out = solver.solve(x0=bt, max_iter=5, rhos=rhos, lams=lams)
    loss = torch.mean((out - torch.from_numpy(img)) ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, (rhos, lams))]


def _solve_grads_jax(observation, prior):
    img, psf, b = observation
    x = jdp.Variable()
    bj = jnp.asarray(b)
    reg = jdp.norm1(jdp.grad(x)) if prior == "norm1" else jdp.deep_prior(x, "tv")
    solver = jdp.compile([jdp.sum_squares(jdp.conv(x, psf) - bj), reg], "admm")

    def loss(rhos, lams):
        out = solver.solve(x0=bj, max_iter=5, rhos=rhos, lams=lams)
        return jnp.mean((out - jnp.asarray(img)) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(RHOS),
                                                                   jnp.asarray(LAMS))]


@pytest.mark.parametrize("prior", ["norm1", "tv"])
def test_unrolled_solve_gradients_match_jax(observation, prior):
    got = _solve_grads_torch(observation, prior)
    ref = _solve_grads_jax(observation, prior)
    for name, g, r in zip(("rhos", "lams"), got, ref):
        assert np.abs(r).max() > 0, name
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= SOLVE_RTOL, (name, err, g, r)


def _complex(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


@pytest.mark.parametrize("name", ["tv", "freq_divide", "freq_divide_complex", "admm_nonneg",
                                  "admm_soft", "cg_tail"])
def test_kernel_functions_backward_equals_autograd_of_plain(monkeypatch, name):
    """The wiring of the four autograd Functions the wrappers use on the
    card (saved tensors, the VJPs, one gradient per input), run here with
    each launch replaced by its plain version (TV's backward launch by the
    plain adjoint, ``tv_denoise_chw_vjp_plain``): the gradients equal
    autograd's through the plain version, to 1e-6 of the largest entry
    (float32 sums in another order)."""
    rng = np.random.RandomState(3)
    shape = (2, 3, 6, 7)
    put = lambda a: torch.from_numpy(np.asarray(a))
    if name == "tv":
        # the forward keeps y0 where the kernel keeps its clip codes, and the
        # backward launch is the plain adjoint from it
        monkeypatch.setattr(kernels, "_tv_launch", lambda y, l, it, codes=False: (
            kernels.tv_denoise_chw_plain(y, l, it), y))
        monkeypatch.setattr(kernels, "_tv_vjp_launch", kernels.tv_denoise_chw_vjp_plain)
        fn, plain = (lambda y, l: kernels._TVFn.apply(y, l, 5),
                     lambda y, l: kernels.tv_denoise_chw_plain(y, l, 5))
        ins = [put(rng.rand(3, 9, 11).astype(np.float32)), put(np.float32([0.05, 0.1, 0.2]))]
    elif name.startswith("freq_divide"):
        monkeypatch.setattr(kernels, "_freq_divide_launch", kernels.freq_divide_plain)
        fn, plain = (lambda F, d, r: kernels._FreqDivideFn.apply(F, d, r, 1e-7),
                     kernels.freq_divide_plain)
        diag = (_complex(rng, 1, 3, 6, 7) + 2.0 if name.endswith("complex")
                else rng.rand(1, 3, 6, 7).astype(np.float32))
        ins = [put(_complex(rng, *shape)), put(diag),
               put((0.1 + rng.rand(2, 1, 1, 1)).astype(np.float32))]
    elif name.startswith("admm"):
        kind = "nonneg" if name == "admm_nonneg" else "soft"
        monkeypatch.setattr(kernels, "_admm_launch", kernels.fused_admm_update_plain)
        fn = lambda K, u, l: kernels._AdmmUpdateFn.apply(K, u, l if kind == "soft" else None, kind)
        plain = lambda K, u, l: kernels.fused_admm_update_plain(K, u, l, kind)
        K = rng.randn(*shape).astype(np.float32)
        K[0, 0, 0, :3] = [0.0, 0.5, -0.25]
        u = rng.randn(*shape).astype(np.float32)
        u[0, 0, 0, :3] = 0.0
        ins = [put(K), put(u), put(np.float32([0.5, 0.25]))]
    else:
        monkeypatch.setattr(kernels, "_cg_tail_launch", kernels.fused_cg_tail_plain)
        fn, plain = (lambda *a: kernels._CgTailFn.apply(*a), kernels.fused_cg_tail_plain)
        x, r, p = (rng.randn(*shape).astype(np.float32) for _ in range(3))
        Ap = (1.5 * p + 0.1 * rng.randn(*shape)).astype(np.float32)
        ins = [put(a) for a in (x, r, p, Ap)] + [kernels.bdot_plain(put(r), put(r))]
    wrt = ins if name != "admm_nonneg" else ins[:2]
    grads = []
    for f in (fn, plain):
        ts = [t.clone().requires_grad_(any(t is w for w in wrt)) for t in ins]
        outs = f(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ws = [torch.from_numpy(np.random.RandomState(7 + i).randn(*o.shape).astype(np.float32))
              for i, o in enumerate(outs)]
        loss = sum((o * w).real.sum() if o.is_complex() else (o * w).sum()
                   for o, w in zip(outs, ws))
        grads.append(torch.autograd.grad(loss, [t for t in ts if t.requires_grad]))
    for g, r in zip(*grads):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())

"""nonneg / norm1 / norm2 of the port against the JAX classes, and the
fused ADMM (v, u) update against the generic prox + dual update.

The proxes are the same float32 elementwise operations in both packages
(atol 1e-6). The fused route (ops/kernels.py::fused_admm_update, here its
plain version) must equal the generic route bit for bit.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu_torch.algo.admm import ADMM
from dprox_tpu_torch.utils import imaging

SHAPE = (2, 3, 12, 10)


@pytest.mark.parametrize("name", ["nonneg", "norm1", "norm2"])
@pytest.mark.parametrize("alpha,beta,with_offset", [
    (1.0, 1.0, False), (2.5, 1.0, False), (1.0, 0.5, False), (1.7, 2.0, True)])
def test_simple_prox_matches_jax(name, alpha, beta, with_offset):
    rng = np.random.RandomState(0)
    v = rng.randn(*SHAPE).astype(np.float32)
    c = rng.randn(*SHAPE).astype(np.float32)
    lam = np.array([0.3, 0.8], np.float32)  # one per batch element

    def build(pkg, const):
        x = pkg.Variable()
        fn = getattr(pkg, name)(x - const if with_offset else x)
        fn.alpha, fn.beta = alpha, beta
        return fn

    got = build(dp, torch.from_numpy(c)).prox(torch.from_numpy(v), torch.from_numpy(lam))
    ref = build(jdp, jnp.asarray(c)).prox(jnp.asarray(v), jnp.asarray(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_scalar_times_fn_sets_alpha_and_constructor_takes_beta():
    fn = 3.0 * dp.norm1(dp.Variable(), beta=2.0)
    assert (fn.alpha, fn.beta) == (3.0, 2.0)


def test_fused_kind_gate():
    x = dp.Variable()
    c = torch.zeros(1, 1, 2, 2)
    assert ADMM._fused_kind(dp.nonneg(x), None) == "nonneg"
    assert ADMM._fused_kind(2.0 * dp.norm1(x), None) == "soft"
    assert ADMM._fused_kind(dp.norm2(x), None) is None
    assert ADMM._fused_kind(dp.norm1(x, beta=0.5), None) is None
    assert ADMM._fused_kind(dp.nonneg(x - c), c) is None
    assert ADMM._fused_kind(dp.deep_prior(x, "tv"), None) is None


class _GenericADMM(ADMM):
    """ADMM with the fused route switched off: every psi fn takes the
    generic prox + dual update."""

    @staticmethod
    def _fused_kind(fn, offset):
        return None


@pytest.mark.parametrize("name,alpha,per_batch", [
    ("nonneg", 1.0, False), ("norm1", 1.0, False), ("norm1", 2.5, True)])
def test_fused_route_equals_generic_route_bit_for_bit(name, alpha, per_batch):
    img = imaging._synthetic_face(512, 512)[100:148, 200:264].transpose(2, 0, 1)
    img = torch.from_numpy(np.stack([img, img[:, ::-1].copy()]))  # B = 2
    psf = imaging.point_spread_function(9, 2)
    b = imaging.blurring(img, psf)
    lams = np.array([[0.01, 0.03]] * 5, np.float32) if per_batch else 0.01

    def solve(cls):
        x = dp.Variable()
        fns = [dp.sum_squares(dp.conv(x, psf) - b), alpha * getattr(dp, name)(x)]
        solver = cls(*cls.partition(fns), device="cpu")
        states = []
        solver.solve(x0=b, max_iter=5, rhos=0.05, lams=lams,
                     callback=lambda iter, state, rho, lam: states.append(state))
        return states

    for fused, generic in zip(solve(ADMM), solve(_GenericADMM)):
        for a, g in zip(fused, generic):  # x, (v,), (u,)
            a, g = (a, g) if isinstance(a, torch.Tensor) else (a[0], g[0])
            assert torch.equal(a, g)

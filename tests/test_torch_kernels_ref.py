"""Plain versions of the port's kernels against the JAX package's kernels.

The CUDA kernels run only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py); here the wrappers take their plain PyTorch versions,
which must compute what the Pallas kernels compute on the same numpy
inputs.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dprox_tpu.models.tv import tv_denoising_chw as jax_tv
from dprox_tpu.ops.pallas_kernels import (_freq_divide_ref, bdot_pallas,
                                          fused_admm_update, fused_cg_tail,
                                          tv_denoise_chw_pallas)
from dprox_tpu_torch.models.tv import tv_denoising_chw
from dprox_tpu_torch.ops import kernels

# the edge and odd-size cases of tests/test_pallas_ops.py (shape, iterations, tile)
TV_CASES = [((3, 40, 56), 4, 32), ((2, 300, 260), 10, 128),
            ((3, 20, 20), 5, 48), ((1, 128, 384), 10, 128)]


@pytest.mark.parametrize("shape,iterations,tile", TV_CASES)
def test_tv_plain_matches_jax_reference_and_pallas(shape, iterations, tile):
    """Same op order as models/tv.py: atol 1e-6 against the jnp reference
    and the Pallas kernel in interpret mode."""
    y = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = tv_denoising_chw(torch.from_numpy(y), 0.08, iterations).numpy()
    ref = np.asarray(jax_tv(jnp.asarray(y), 0.08, iterations))
    pallas = np.asarray(tv_denoise_chw_pallas(jnp.asarray(y), 0.08, iterations,
                                              tile=tile, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)


def test_tv_plain_per_plane_lam_matches_jax_per_plane():
    """lam given once per plane equals running each plane with its own lam."""
    rng = np.random.RandomState(1)
    y = rng.rand(3, 33, 47).astype(np.float32)
    lam = np.array([0.02, 0.08, 0.2], np.float32)
    got = tv_denoising_chw(torch.from_numpy(y), torch.from_numpy(lam), 6).numpy()
    for p in range(3):
        ref = np.asarray(jax_tv(jnp.asarray(y[p:p + 1]), jnp.asarray(lam[p]), 6))
        np.testing.assert_allclose(got[p:p + 1], ref, rtol=0, atol=1e-6)


def test_tv_wrapper_takes_plain_version_on_cpu():
    y = torch.from_numpy(np.random.RandomState(2).rand(2, 37, 53).astype(np.float32))
    lam = torch.tensor([0.05])
    kernels.reset_launches()
    out = kernels.tv_denoise_chw(y, lam, 10)
    assert torch.equal(out, kernels.tv_denoise_chw_plain(y, lam, 10))
    assert set(kernels.launch_counts().values()) == {0}


DIVIDE_CASES = [  # (F shape, diag shape, rho shape)
    ((1, 3, 16, 24), (1, 3, 16, 24), ()),
    ((2, 3, 16, 24), (1, 3, 16, 24), (2, 1, 1, 1)),
    ((2, 1, 8, 5), (), (2, 1, 1, 1)),
    ((1, 3, 32, 17), (1, 3, 32, 17), (1,)),
]


@pytest.mark.parametrize("fshape,dshape,rshape", DIVIDE_CASES)
def test_freq_divide_plain_matches_jax_reference(fshape, dshape, rshape):
    rng = np.random.RandomState(3)
    F = (rng.randn(*fshape) + 1j * rng.randn(*fshape)).astype(np.complex64)
    diag = np.asarray(rng.rand(*dshape), np.float32)
    rho = np.asarray(1e-3 * (1 + rng.rand(*rshape)), np.float32)
    got = kernels.freq_divide(torch.from_numpy(F), torch.from_numpy(diag),
                              torch.from_numpy(rho)).numpy()
    ref = np.asarray(_freq_divide_ref(jnp.asarray(F), jnp.asarray(diag), jnp.asarray(rho)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["nonneg", "soft"])
@pytest.mark.parametrize("shape,lam", [((1, 3, 16, 128), 0.1), ((2, 3, 7, 9), 0.35)])
def test_fused_admm_update_plain_equals_jax(kind, shape, lam):
    """The same float32 elementwise operations in both packages: exact.
    (The JAX function takes its jnp path on the CPU.)"""
    rng = np.random.RandomState(4)
    Kx, u = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    Kx.flat[:2] = 0.0
    u.flat[:2] = [0.0, -0.0]
    v, u_new = kernels.fused_admm_update(torch.from_numpy(Kx), torch.from_numpy(u),
                                         torch.tensor(lam), kind)
    v_ref, u_ref = fused_admm_update(jnp.asarray(Kx), jnp.asarray(u), lam, kind)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(u_new.numpy(), np.asarray(u_ref))


def test_fused_admm_update_plain_takes_lam_per_batch_element():
    rng = np.random.RandomState(5)
    Kx, u = (torch.from_numpy(rng.randn(3, 2, 5, 6).astype(np.float32)) for _ in range(2))
    lam = torch.tensor([0.1, 0.5, 0.9])
    v, u_new = kernels.fused_admm_update(Kx, u, lam, "soft")
    for i in range(3):
        vi, ui = kernels.fused_admm_update(Kx[i:i + 1], u[i:i + 1], lam[i], "soft")
        assert torch.equal(v[i:i + 1], vi) and torch.equal(u_new[i:i + 1], ui)


@pytest.mark.parametrize("shape,dtype", [((4, 3, 8, 128), np.float32),
                                         ((1, 8208), np.float32), ((1, 8208), np.float64)])
def test_bdot_plain_matches_jax(shape, dtype):
    """atol 1e-3 at 4x3x8x128 as in tests/test_pallas_ops.py, and relative
    1e-6 (float32, sums in two orders) / 1e-12 (float64) of sum |p q|; also
    at path C's row of 8208 LP variables, in float32 and, with JAX's x64 on,
    float64."""
    rng = np.random.RandomState(2)
    p = rng.randn(*shape).astype(dtype)
    q = rng.randn(*shape).astype(dtype)
    got = kernels.bdot(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    with jax.enable_x64(bool(dtype == np.float64)):
        ref = np.asarray(bdot_pallas(jnp.asarray(p), jnp.asarray(q)))
    assert got.shape == (shape[0],) and got.dtype == ref.dtype == dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    scale = np.abs(p * q).reshape(shape[0], -1).sum(1)
    assert np.all(np.abs(got - ref) <= (1e-6 if dtype == np.float32 else 1e-12) * scale)


def test_fused_cg_tail_plain_matches_pallas_interpret():
    """Against the Pallas kernel in interpret mode, rtol/atol 1e-4 as in
    tests/test_pallas_ops.py."""
    rng = np.random.RandomState(5)
    shp = (2, 3, 16, 128)
    x, r, p, Ap = (rng.randn(*shp).astype(np.float32) for _ in range(4))
    rs = (r.reshape(2, -1) ** 2).sum(1)
    got = kernels.fused_cg_tail(*(torch.from_numpy(a) for a in (x, r, p, Ap, rs)))
    ref = fused_cg_tail(*(jnp.asarray(a) for a in (x, r, p, Ap, rs)), interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_fused_cg_tail_plain_clamps():
    """<p, Ap> = 0 and rs = 0 divide by the 1e-32 clamp, not by zero."""
    x = torch.ones(2, 4)
    zeros = torch.zeros(2, 4)
    out = kernels.fused_cg_tail(x, zeros, zeros, zeros, torch.zeros(2))
    assert torch.equal(out[0], x) and all(bool(torch.isfinite(t).all()) for t in out)
    assert float(out[3].abs().max()) == 0.0


def test_solver_wrappers_take_plain_version_on_cpu():
    t = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 5, 7).astype(np.float32))
    kernels.reset_launches()
    assert torch.equal(kernels.bdot(t, t), kernels.bdot_plain(t, t))
    for a, b in zip(kernels.fused_admm_update(t, t, torch.tensor(0.2), "soft"),
                    kernels.fused_admm_update_plain(t, t, torch.tensor(0.2), "soft")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        kernels.fused_admm_update(t, t, torch.tensor(0.2), "l2")
    tiles, ids = torch.ones(2, 3, 4), torch.tensor([0, 1], dtype=torch.int32)
    assert torch.equal(kernels.bsr_matvec(tiles, ids, ids, torch.ones(2, 4), 2),
                       kernels.bsr_matvec_plain(tiles, ids, ids, torch.ones(2, 4), 2))
    indptr, cols = torch.tensor([0, 2, 3], dtype=torch.int32), torch.tensor([0, 3, 1], dtype=torch.int32)
    split = kernels.csr_split(indptr)
    assert torch.equal(kernels.csr_matvec(indptr, cols, torch.ones(3), torch.arange(4.0)),
                       kernels.csr_matvec_plain(indptr, cols, torch.ones(3), torch.arange(4.0), split))
    assert set(kernels.launch_counts()) == {"tv_denoise_chw", "tv_denoise_chw_vjp",
                                            "freq_divide", "bsr_matvec",
                                            "csr_matvec", "fused_admm_update", "bdot",
                                            "fused_cg_tail", "freq_divide_complex",
                                            "mcg_start", "mcg_residual", "mcg_otf_apply",
                                            "mcg_mask", "mcg_gram", "mcg_step",
                                            "mcg_precond", "mcg_real", "mcg_direction"}
    assert set(kernels.launch_counts().values()) == {0}


def test_wrappers_reject_non_tensors():
    with pytest.raises(TypeError):
        kernels.tv_denoise_chw(np.zeros((1, 4, 4), np.float32), 0.1, 2)
    with pytest.raises(TypeError):
        kernels.freq_divide(np.zeros((1, 1, 4, 4), np.complex64), torch.ones(()), torch.ones(()))

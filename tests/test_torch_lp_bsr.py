"""The port's LP operators against the JAX package and scipy, on the CPU.

Same scipy matrices (numpy seeds) go through dprox_tpu.algo.lp.utils and
dprox_tpu_torch.algo.lp.utils. Tolerances: the BSRMat arrays are equal
bit for bit (same host construction, one rounding to the device dtype);
products agree with scipy's float64 product to rtol 1e-12 in float64
(sums of a few dozen terms in another order) and 1e-5 of the largest
entry in float32; host-side float64 preprocessing (Ruiz equilibration,
the synthetic energy models) is equal exactly. On CPU tensors the port's
``bsr_matvec`` wrapper runs its plain version; the CUDA kernel is held
against the same plain version on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

from dprox_tpu.algo.lp import utils as jutils
from dprox_tpu.contrib import energy_system as jenergy
from dprox_tpu.ops import pallas_kernels as jkernels
from dprox_tpu_torch.algo.lp import utils
from dprox_tpu_torch.contrib import energy_system
from dprox_tpu_torch.ops import kernels

ARRAYS = ("tiles", "row_ids", "col_ids", "tilesT", "row_idsT", "col_idsT")
SHAPES = [(70, 33), (256, 300), (13, 513)]  # the odd sizes of tests/test_lp.py


@pytest.fixture(autouse=True, scope="module")
def enable_x64():
    """float64 in JAX for this module, as tests/test_lp.py; and one torch
    thread: these loops are thousands of tiny ops, which several test
    workers with a thread pool each only slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(threads)


def _matrix(m, n, seed=3, density=0.05):
    return sp.random(m, n, density=density, random_state=np.random.RandomState(seed),
                     format="csr")


def _pair(A, dtype, **kw):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    return jutils.BSRMat(A, dtype=jdt, **kw), utils.BSRMat(A, dtype=dtype, device="cpu", **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,blocks", [(s, {}) for s in SHAPES]
                         + [((150, 90), {"bm": 32, "bn": 16})])
def test_bsrmat_arrays_equal_jax_bit_for_bit(shape, blocks, dtype):
    jop, op = _pair(_matrix(*shape), dtype, **blocks)
    for name in ARRAYS:
        got, ref = getattr(op, name).numpy(), np.asarray(getattr(jop, name))
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert np.array_equal(got, ref), name
    assert (op.shape, op.bm, op.bn, op.Mb, op.Nb, op.n_tiles, op.nse) == \
        (jop.shape, jop.bm, jop.bn, jop.Mb, jop.Nb, jop.n_tiles, jop.nse)
    assert op.nbytes() == jop.nbytes()
    assert op.T.shape == (shape[1], shape[0]) and op.T.nse == op.nse
    # the kernel's offsets delimit each output block's tiles
    for ptr, ids, nb in ((op.row_ptr, op.row_ids, op.Mb), (op.row_ptrT, op.col_idsT, op.Nb)):
        counts = np.bincount(ids.numpy(), minlength=nb)
        assert np.array_equal(np.diff(ptr.numpy()), counts) and int(ptr[0]) == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", SHAPES)
def test_matvec_rmatvec_match_jax_and_scipy(shape, dtype, tol):
    m, n = shape
    A = _matrix(m, n)
    jop, op = _pair(A, dtype)
    rng = np.random.RandomState(0)
    x, y = rng.rand(n), rng.rand(m)
    for v, fwd, ref in ((x, lambda o, t: o @ t, A @ x), (y, lambda o, t: o.T @ t, A.T @ y)):
        got = fwd(op, torch.as_tensor(v).to(dtype)).numpy()
        jref = np.asarray(fwd(jop, jnp.asarray(v, jop.tiles.dtype)))
        scale = max(np.abs(ref).max(), 1e-30)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= tol * scale
        assert np.abs(got - jref).max() <= tol * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_wrapper_matches_pallas_interpret_float32(shape):
    """The port's wrapper (plain version on the CPU) against the Pallas
    kernel in interpret mode, the way the JAX package's tests run it on
    the CPU: float32 sums in another order, 1e-5 of the largest entry."""
    jop, op = _pair(_matrix(*shape), torch.float32)
    x = np.random.RandomState(1).rand(op.Nb, op.bn).astype(np.float32)
    ref = np.asarray(jkernels.bsr_matvec(jop.tiles, jop.col_ids, jop.row_ids, jnp.asarray(x),
                                         jop.Mb, interpret=True))
    got = kernels.bsr_matvec(op.tiles, op.col_ids, op.row_ids, torch.from_numpy(x), op.Mb)
    with_ptr = kernels.bsr_matvec(op.tiles, op.col_ids, op.row_ids, torch.from_numpy(x),
                                  op.Mb, row_ptr=op.row_ptr)
    assert torch.equal(got, with_ptr)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert torch.equal(kernels.bsr_row_ptr(op.row_ids, op.Mb), op.row_ptr)


def test_wrapper_zero_fills_empty_output_blocks_and_no_tiles():
    A = sp.lil_matrix((5 * 16, 3 * 16))
    A[0:3, 0:4] = 1.5      # output block 0
    A[70:75, 40:44] = -2.0  # output block 4; blocks 1..3 have no tile
    op = utils.BSRMat(A.tocsr(), bm=16, bn=16, dtype=torch.float64, device="cpu")
    x = torch.arange(48, dtype=torch.float64)
    np.testing.assert_allclose((op @ x).numpy(), A.tocsr() @ x.numpy(), rtol=1e-12)
    assert float((op @ x)[16:64].abs().max()) == 0.0
    empty = utils.BSRMat(sp.csr_matrix((40, 30)), bm=16, bn=16, dtype=torch.float32, device="cpu")
    assert empty.n_tiles == 0 and torch.equal(empty @ torch.ones(30), torch.zeros(40))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_matmat_rmatmat_match_jax_and_scipy(dtype, tol):
    A = _matrix(180, 230, seed=5)
    jop, op = _pair(A, dtype)
    rng = np.random.RandomState(5)
    X, Y = rng.rand(230, 6), rng.rand(180, 6)
    for V, name, ref in ((X, "matmat", A @ X), (Y, "rmatmat", A.T @ Y)):
        got = getattr(op, name)(torch.as_tensor(V).to(dtype)).numpy()
        jref = np.asarray(getattr(jop, name)(jnp.asarray(V, jop.tiles.dtype)))
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
        assert np.abs(got - jref).max() <= tol * np.abs(ref).max()
    # a non-contiguous (transposed) operand, as ScenarioLP.apply_A passes it
    Xt = torch.as_tensor(X.T.copy()).to(dtype)
    assert torch.equal(op.matmat(Xt.T), op.matmat(Xt.T.contiguous()))


def test_gradient_through_matvec_is_the_transposed_apply():
    """grad of sum((A x)^2) = 2 A^T A x (float64, rtol 1e-10), equal to
    jax.grad through the JAX operator's custom_vjp; and through A^T."""
    rng = np.random.RandomState(1)
    A = sp.random(40, 30, density=0.2, random_state=rng, format="csr")
    jop, op = _pair(A, torch.float64)
    x0, y0 = rng.rand(30), rng.rand(40)
    x = torch.as_tensor(x0).requires_grad_()
    g, = torch.autograd.grad(torch.sum((op @ x) ** 2), x)
    np.testing.assert_allclose(g.numpy(), 2 * A.T @ (A @ x0), rtol=1e-10)
    jg = jax.grad(lambda v: jnp.sum((jop @ v) ** 2))(jnp.asarray(x0))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10)
    y = torch.as_tensor(y0).requires_grad_()
    gT, = torch.autograd.grad(torch.sum((op.T @ y) ** 2), y)
    np.testing.assert_allclose(gT.numpy(), 2 * A @ (A.T @ y0), rtol=1e-10)
    # second order: the backward is itself an apply with a backward
    gg, = torch.autograd.grad(
        torch.autograd.grad(torch.sum((op @ x) ** 2), x, create_graph=True)[0].sum(), x)
    np.testing.assert_allclose(gg.numpy(), 2 * A.T @ (A @ np.ones(30)), rtol=1e-10)
    assert torch.autograd.gradcheck(lambda v: op @ v, (x,), eps=1e-6, atol=1e-6)


def test_budget_fallback_to_sparse_operators(monkeypatch):
    rng = np.random.RandomState(0)
    A = sp.random(400, 400, density=0.01, random_state=rng, format="csr")
    op, opT = utils.scipy_to_device_op(A, dtype=torch.float64, tile_budget_bytes=16,
                                       device="cpu")
    assert isinstance(op, utils.SparseOp) and op.shape == (400, 400)
    x0 = rng.rand(400)
    x = torch.as_tensor(x0).requires_grad_()
    np.testing.assert_allclose((op @ x).detach().numpy(), A @ x0, rtol=1e-10)
    np.testing.assert_allclose((opT @ x).detach().numpy(), A.T @ x0, rtol=1e-10)
    g, = torch.autograd.grad(torch.sum((op @ x) ** 2), x)
    np.testing.assert_allclose(g.numpy(), 2 * A.T @ (A @ x0), rtol=1e-10)
    X = rng.rand(400, 3)
    np.testing.assert_allclose((op @ torch.as_tensor(X)).numpy(), A @ X, rtol=1e-10)
    # same byte rule as the JAX package: both tile copies at the dtype
    T = utils.BSRMat(A, dtype=torch.float64, device="cpu").n_tiles
    at, below = 2 * T * 128 * 128 * 8, 2 * T * 128 * 128 * 8 - 1
    assert isinstance(utils.scipy_to_device_op(A, torch.float64, tile_budget_bytes=at,
                                               device="cpu")[0], utils.BSRMat)
    assert isinstance(utils.scipy_to_device_op(A, torch.float64, tile_budget_bytes=below,
                                               device="cpu")[0], utils.SparseOp)
    assert isinstance(jutils.scipy_to_device_op(A, jnp.float64, tile_budget_bytes=at)[0],
                      jutils.BSRMat)
    monkeypatch.setenv("DPROX_LP_TILE_BUDGET", "16")
    assert isinstance(utils.scipy_to_device_op(A, torch.float64, device="cpu")[0],
                      utils.SparseOp)


def test_bsr_from_numpy_rebuilds_the_jax_operator():
    A = _matrix(150, 90)
    jop = jutils.BSRMat(A, bm=32, bn=16, dtype=jnp.float64)
    op = utils.bsr_from_numpy([np.asarray(getattr(jop, n)) for n in ARRAYS], jop.shape,
                              bm=32, bn=16, device="cpu")
    ref = utils.BSRMat(A, bm=32, bn=16, dtype=torch.float64, device="cpu")
    for name in ARRAYS + ("row_ptr", "row_ptrT"):
        assert torch.equal(getattr(op, name), getattr(ref, name)), name
    x = torch.as_tensor(np.random.RandomState(2).rand(90))
    assert torch.equal(op @ x, ref @ x) and op.dtype == torch.float64
    params = utils.lp_params_from_numpy({"rho": np.float64(2.0), "alpha": 1.6}, device="cpu")
    assert params["rho"].dtype == torch.float64 and params["rho"].ndim == 0
    assert float(params["alpha"]) == 1.6


def test_ruiz_equilibration_equals_jax_package():
    rng = np.random.RandomState(4)
    A = sp.vstack([_matrix(30, 20, seed=4, density=0.3), sp.eye(20)])
    c, b = rng.rand(20) + 0.1, np.concatenate([rng.rand(30), np.full(20, np.inf)])
    got = utils.ruiz_equilibration_sparse(A, c, b)
    ref = jutils.ruiz_equilibration_sparse(A, c, b)
    for g, r in zip(got, ref):
        if sp.issparse(g):
            assert np.array_equal(g.toarray(), r.toarray())
        else:
            assert np.array_equal(np.asarray(g), np.asarray(r))


def test_synthetic_energy_models_equal_jax_package():
    def same(got, ref):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            g, r = (a.toarray() if sp.issparse(a) else np.asarray(a) for a in (g, r))
            assert np.array_equal(g, r)

    same(energy_system.synthetic_cep_model(16, 4), jenergy.synthetic_cep_model(16, 4))
    same(energy_system.synthetic_cep_model(8, 3, seed=2), jenergy.synthetic_cep_model(8, 3, seed=2))
    got = energy_system.synthetic_cep_scenarios(16, 4, 5)
    same(got, jenergy.synthetic_cep_scenarios(16, 4, 5))
    same(energy_system.extensive_form(*got), jenergy.extensive_form(*got))
    # without the instance file the loader gives the synthetic model
    same(energy_system.load_simple_cep_model(), energy_system.synthetic_cep_model())

"""The compressed-row route of the port's LP operator against scipy and the
JAX package, on the CPU.

``BSRMat`` derives compressed rows of A and A^T from its dense tiles and
applies them through ``kernels.csr_matvec`` when they move fewer bytes than
the tiles; on CPU tensors that wrapper runs its plain version, which the
CUDA kernel is held against on the card (tests/test_torch_cuda.py).
Tolerances: the arrays are equal bit for bit (the same host construction and
one rounding to the dtype); products agree with the JAX package's tile
products to 1e-5 of the largest entry in float32 and 1e-12 in float64 (the
same terms summed in another order); a row cut into pieces gives the uncut
row's sum exactly on integer-valued data (every partial sum is an integer
below 2**24) and, on random float32 data, the exact sum to 1e-5 (float32
rounding of sums of up to 9001 terms).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

from dprox_tpu.algo.lp import utils as jutils
from dprox_tpu.ops import pallas_kernels as jkernels
from dprox_tpu_torch.algo import lp
from dprox_tpu_torch.algo.lp import utils
from dprox_tpu_torch.contrib.energy_system import synthetic_cep_model
from dprox_tpu_torch.ops import kernels

ARRAYS = ("tiles", "row_ids", "col_ids", "tilesT", "row_idsT", "col_idsT")
SHAPES = [(70, 33), (256, 300), (13, 513)]  # as tests/test_torch_lp_bsr.py
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(autouse=True, scope="module")
def enable_x64():
    """float64 in JAX for this module, and one torch thread, as the other
    LP test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(threads)


def _matrix(m, n, seed=3, density=0.05):
    return sp.random(m, n, density=density, random_state=np.random.RandomState(seed),
                     format="csr")


def arrow(n_blocks, b, seed=0):
    """Block-angular (arrow) matrix: dense diagonal blocks and a dense first
    block column, n_blocks block rows of b x b; 2 n_blocks - 1 tiles."""
    rng = np.random.RandomState(seed)
    dense = lambda: sp.csr_matrix(0.5 + rng.rand(b, b))
    grid = [[None] * n_blocks for _ in range(n_blocks)]
    for i in range(n_blocks):
        grid[i][i] = dense()
        if i:
            grid[i][0] = dense()
    return sp.bmat(grid, format="csr")


def _csr(M, dtype):
    M = sp.csr_matrix(M, copy=True)
    M.eliminate_zeros()
    M.sort_indices()
    return (M.indptr.astype(np.int32), M.indices.astype(np.int32),
            torch.from_numpy(M.data).to(dtype).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,blocks", [(s, {}) for s in SHAPES]
                         + [((150, 90), {"bm": 32, "bn": 16})])
def test_compressed_rows_equal_scipy_from_both_constructions(shape, blocks, dtype):
    """From scipy (BSRMat) and from the JAX package's six arrays
    (bsr_from_numpy): the compressed rows of A and of A^T equal scipy's."""
    A = _matrix(*shape)
    A.data[::7] = 0.0  # explicit zeros: dropped
    jop = jutils.BSRMat(A, dtype=JDT[dtype], **blocks)
    ops = [utils.BSRMat(A, dtype=dtype, device="cpu", **blocks),
           utils.bsr_from_numpy([np.asarray(getattr(jop, n)) for n in ARRAYS], jop.shape,
                                device="cpu", **blocks)]
    for op in ops:
        assert op.route == "csr" and op.nnz == sp.csr_matrix(A).count_nonzero()
        for (indptr, indices, values, split), M in ((op.csr, A), (op.csrT, A.T)):
            ref = _csr(M, dtype)
            assert indptr.dtype == indices.dtype == torch.int32 and values.dtype == dtype
            for got, want in zip((indptr, indices, values), ref):
                assert np.array_equal(got.numpy(), want)
            assert split.n_rows == M.shape[0]
    for a, b in zip(ops[0].csr + ops[0].csrT, ops[1].csr + ops[1].csrT):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_tile_products(shape, dtype, tol):
    """csr_matvec (its plain version here) in both directions against the
    JAX package's bsr_matvec: the Pallas kernel in interpret mode (float32,
    as the JAX package's own tests run it on the CPU) and _bsr_matvec_ref."""
    jop = jutils.BSRMat(_matrix(*shape), dtype=JDT[dtype])
    op = utils.bsr_from_numpy([np.asarray(getattr(jop, n)) for n in ARRAYS], jop.shape,
                              device="cpu")
    rng = np.random.RandomState(1)
    for (indptr, indices, values, split), args, (m, n) in (
            (op.csr, (jop.tiles, jop.col_ids, jop.row_ids, jop.Nb, jop.Mb), shape),
            (op.csrT, (jop.tilesT, jop.row_idsT, jop.col_idsT, jop.Mb, jop.Nb), shape[::-1])):
        tiles, idx_in, idx_out, n_in, n_out = args
        xb = rng.rand(n_in, tiles.shape[2]).astype(np.dtype(JDT[dtype]))
        xb.reshape(-1)[n:] = 0.0
        got = kernels.csr_matvec(indptr, indices, values,
                                 torch.from_numpy(xb.reshape(-1)[:n].copy()), split)
        refs = [jkernels._bsr_matvec_ref(tiles, idx_in, idx_out, jnp.asarray(xb), n_out)]
        if dtype == torch.float32:
            refs.append(jkernels.bsr_matvec(tiles, idx_in, idx_out, jnp.asarray(xb), n_out,
                                            interpret=True))
        for ref in refs:
            ref = np.asarray(ref).reshape(-1)[:m]
            assert got.dtype == dtype and got.shape == (m,)
            assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def _long_rows(long, seed=0):
    """Rows of 0, 1, 16, 17, 128, 129 and 1000 non-zeros, and ``long`` rows
    whose one non-zero is in column 5: with the transpose's row of ``long``
    non-zeros, every length threshold of csr_split is crossed
    (CSR_SHORT_ROW 16, CSR_WARP_ROW 128, CSR_CHUNK 4096)."""
    rng = np.random.RandomState(seed)
    A = sp.lil_matrix((8, 1200))
    for r, k in enumerate([0, 1, 16, 17, 128, 129, 1000, 3]):
        A[r, rng.choice(1200, k, replace=False)] = 1.0 + rng.rand(k)
    col = sp.csr_matrix((1.0 + rng.rand(long), (np.arange(long), np.full(long, 5))),
                        (long, 1200))
    return sp.csr_matrix(sp.vstack([A.tocsr(), col]), dtype=np.float64)


@pytest.mark.parametrize("long", [4097, 4200, 8192, 9001])
def test_cut_rows_give_the_uncut_sums(long):
    """A row of more than CSR_CHUNK non-zeros is summed in pieces, then the
    pieces in order. On integer-valued data every partial sum is exact in
    both dtypes (below 2**24), so the cut gives the uncut sum bit for bit;
    on random float32 data it is within 1e-5 of the largest exact entry (a
    float32 sum of up to 9001 terms, in any order, drifts ~1e-6)."""
    A = _long_rows(long)
    rng = np.random.RandomState(2)
    for M in (A, sp.csr_matrix(A.T)):
        indptr, indices = (torch.from_numpy(a.astype(np.int32)) for a in (M.indptr, M.indices))
        split = kernels.csr_split(indptr)
        lengths = np.diff(M.indptr)
        pieces = -(-lengths // kernels.CSR_CHUNK)
        assert split.n_split == int((pieces > 1).sum()) == (M.shape[0] == 1200)
        assert split.n_split_pieces == int(pieces[pieces > 1].sum())
        # every piece lies inside its row and the pieces tile the rows longer
        # than a thread's
        own, b, e = split.owner.numpy(), split.begin.numpy(), split.end.numpy()
        assert (M.indptr[own] <= b).all() and (e <= M.indptr[own + 1]).all()
        assert ((e - b) <= kernels.CSR_CHUNK).all()
        wide = lengths > kernels.CSR_SHORT_ROW
        assert set(own) == set(np.flatnonzero(wide)) and (e - b).sum() == lengths[wide].sum()
        for dtype in (torch.float64, torch.float32):
            vals = rng.randint(-9, 10, M.nnz).astype(np.float64)
            x = rng.randint(-9, 10, M.shape[1]).astype(np.float64)
            got = kernels.csr_matvec(indptr, indices, torch.from_numpy(vals).to(dtype),
                                     torch.from_numpy(x).to(dtype), split)
            exact = sp.csr_matrix((vals, M.indices, M.indptr), M.shape) @ x
            assert got.dtype == dtype and np.array_equal(got.double().numpy(), exact)
        vals, x = rng.rand(M.nnz), rng.rand(M.shape[1])
        got = kernels.csr_matvec(indptr, indices, torch.from_numpy(vals).float(),
                                 torch.from_numpy(x).float(), split)
        exact = sp.csr_matrix((vals.astype(np.float32).astype(np.float64), M.indices,
                               M.indptr), M.shape) @ x.astype(np.float32).astype(np.float64)
        assert np.abs(got.double().numpy() - exact).max() <= 1e-5 * np.abs(exact).max()


def test_csr_split_sorts_rows_by_length():
    """Rows of at most CSR_SHORT_ROW non-zeros (empty ones too) stay with
    the row path; the pieces of cut rows come first, then the rows of one
    block, then the warp rows; the plain version sums through the same
    cut."""
    lengths = [0, 3, 17, 129, 5000, 0, 8193]
    ptr = np.concatenate([[0], np.cumsum(lengths)])  # 0 0 3 20 149 5149 5149 13342
    s = kernels.csr_split(ptr)
    assert (s.n_rows, s.n_wide, s.n_split, s.n_split_pieces) == (7, 6, 2, 5)
    assert s.owner.tolist() == [4, 4, 6, 6, 6, 3, 2]
    assert s.begin.tolist() == [149, 4245, 5149, 9245, 13341, 20, 3]
    assert s.end.tolist() == [4245, 5149, 9245, 13341, 13342, 149, 20]
    assert s.split_ptr.tolist() == [0, 2, 5]
    assert s.seg_owner.tolist() == [0, 1, 2, 3, 4, 4, 5, 6, 6, 6]
    assert s.item_seg[[0, 2, 3, 19, 20, 148, 149, 4244, 4245, 5148, 5149, 13341]].tolist() == [
        1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 7, 9]
    y = kernels.csr_matvec_plain(torch.from_numpy(ptr.astype(np.int32)),
                                 torch.zeros(ptr[-1], dtype=torch.int32), torch.ones(ptr[-1]),
                                 torch.ones(1), s)
    assert y.tolist() == [float(k) for k in lengths]
    short = kernels.csr_split(np.array([0, 0, 3, 19]))  # no row beyond a thread's
    assert short.owner.numel() == 0 and short.seg_owner is None
    assert short.item_seg.tolist() == [1] * 3 + [2] * 16
    with pytest.raises(ValueError):
        kernels.csr_split(np.array([0, 3, 2]))


def test_route_follows_the_bytes():
    """The energy-planning LP takes compressed rows; a block-dense arrow
    operator keeps its tiles; both give scipy's products."""
    c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(64, 8)
    p = lp.LPProblem(c, A_ub, b_ub, A_eq, b_eq, dtype=torch.float32, device="cpu")
    assert p.A.route == "csr" and p.AT.base.route == "csr"
    A = arrow(12, 16)
    op = utils.BSRMat(A, bm=16, bn=16, dtype=torch.float64, device="cpu")
    assert op.route == "tiles" and op.n_tiles == 23 and not hasattr(op, "csr")
    rng = np.random.RandomState(3)
    x, y = rng.rand(A.shape[1]), rng.rand(A.shape[0])
    np.testing.assert_allclose((op @ torch.from_numpy(x)).numpy(), A @ x, rtol=1e-12)
    np.testing.assert_allclose((op.T @ torch.from_numpy(y)).numpy(), A.T @ y, rtol=1e-12)
    # an operator with no non-zeros: tiles (0 bytes), zeros
    empty = utils.BSRMat(sp.csr_matrix((40, 30)), bm=16, bn=16, device="cpu")
    assert empty.route == "tiles" and torch.equal(empty @ torch.ones(30), torch.zeros(40))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradient_through_the_compressed_route_is_the_transposed_apply(dtype):
    A = _long_rows(4200, seed=4)
    op = utils.BSRMat(A, dtype=dtype, device="cpu")
    assert op.route == "csr" and op.csrT[3].n_split > 0
    rng = np.random.RandomState(5)
    for apply, back, (m, n) in ((lambda v: op @ v, lambda w: op.T @ w, A.shape),
                                (lambda v: op.T @ v, lambda w: op @ w, A.shape[::-1])):
        x = torch.from_numpy(rng.rand(n)).to(dtype).requires_grad_()
        w = torch.from_numpy(rng.rand(m)).to(dtype)
        g, = torch.autograd.grad(torch.dot(apply(x), w), x)
        assert torch.equal(g, back(w))
    x = torch.from_numpy(rng.rand(A.shape[1])).to(dtype).requires_grad_()
    if dtype == torch.float64:
        assert torch.autograd.gradcheck(lambda v: op @ v, (x,), eps=1e-6, atol=1e-6)


def test_matmat_sums_each_output_block_in_tile_order():
    """matmat / rmatmat add each output block's tile products in tile
    order: equal to a loop over the tiles, bit for bit, in float32."""
    A = arrow(5, 16, seed=2)
    op = utils.BSRMat(A, bm=16, bn=16, dtype=torch.float32, device="cpu")
    V = torch.from_numpy(np.random.RandomState(6).rand(80, 3).astype(np.float32))
    for got, tiles, idx_in, idx_out in ((op.matmat(V), op.tiles, op.col_ids, op.row_ids),
                                        (op.rmatmat(V), op.tilesT, op.row_idsT, op.col_idsT)):
        prod = torch.bmm(tiles, V.reshape(5, 16, 3)[idx_in.long()])
        ref = torch.zeros(5, 16, 3)
        for t in range(tiles.shape[0]):
            ref[idx_out[t]] += prod[t]
        assert torch.equal(got, ref.reshape(80, 3))

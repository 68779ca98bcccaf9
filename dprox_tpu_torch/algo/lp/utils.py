"""LP utilities: Ruiz equilibration and sparse device operators.

Counterpart of dprox_tpu/algo/lp/utils.py. Equilibration runs on the
host on scipy sparse matrices (one-time preprocessing); the equilibrated
matrix becomes a pair of device operators (A, A^T) whose matvecs run
inside the ADMM loop: ``BSRMat`` (the ``csr_matvec`` or the
``bsr_matvec`` kernel, whichever moves fewer bytes) when the tiles fit a
byte budget, else ``torch.sparse`` tensors.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from scipy.sparse import linalg as slinalg

from ...ops import kernels
from ...utils.misc import resolve_device


def ruiz_equilibration_sparse(A: sp.spmatrix, c: np.ndarray, b: np.ndarray,
                              ord=np.inf, max_iters: int = 20,
                              verbose: bool = False):
    """Iterative row/column inf-norm scaling, float64 on the host."""
    A = sp.csr_matrix(A, dtype=np.float64)
    m, n = A.shape
    e = np.ones(m)
    d = np.ones(n)
    A_bar = A.copy()
    eps_equil = 1e-3
    for _ in range(max_iters):
        cn = slinalg.norm(A_bar, ord=np.inf, axis=0)
        rn = slinalg.norm(A_bar, ord=np.inf, axis=1)
        cn[cn == 0] = 1.0
        rn[rn == 0] = 1.0
        delta1 = 1.0 / np.sqrt(cn)
        delta2 = 1.0 / np.sqrt(rn)
        d = d * delta1
        e = e * delta2
        A_bar = sp.diags(e) @ A @ sp.diags(d)
        if max(np.abs(1 - delta1).max(), np.abs(1 - delta2).max()) < eps_equil:
            break
    c_bar = c * d
    Arnorm = slinalg.norm(A_bar, ord=np.inf, axis=1)
    Acnorm = slinalg.norm(A_bar, ord=np.inf, axis=0)
    b_bar = b * e[: b.shape[0]]
    nrm_c = np.linalg.norm(c_bar, ord=np.inf)
    finite_b = b_bar[np.isfinite(b_bar)]
    nrm_b = np.linalg.norm(finite_b, ord=np.inf) if finite_b.size else 1.0
    gamma_c = (1.0 / nrm_c if nrm_c > 0 else 1.0) * Arnorm.mean()
    gamma_b = (1.0 / nrm_b if nrm_b > 0 else 1.0) * Acnorm.mean()
    if verbose:
        print(f"Acnorm max/mean: {Acnorm.max():.3f}/{Acnorm.mean():.3f}")
    return d, e, float(gamma_c), float(gamma_b), A_bar, Acnorm


def _row_ptr(sorted_ids: np.ndarray, n_blocks: int) -> np.ndarray:
    return np.searchsorted(sorted_ids, np.arange(n_blocks + 1)).astype(np.int32)


def _compressed_rows(tiles, out_ids, in_ids, b_out: int, b_in: int, n_rows: int):
    """(indptr, indices, values) of the matrix whose (b_out x b_in) tile t
    sits at block (out_ids[t], in_ids[t]); explicit zeros are dropped."""
    t, i, j = np.nonzero(tiles)
    rows = np.asarray(out_ids, np.int64)[t] * b_out + i
    cols = np.asarray(in_ids, np.int64)[t] * b_in + j
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n_rows))])
    return indptr, cols[order], tiles[t, i, j][order]


class BSRMat:
    """Static block-sparse device operator.

    The non-zero (bm x bn) tiles of the matrix are stored densely and a
    matvec is one ``bsr_matvec`` kernel launch (ops/kernels.py). Structured
    LP constraint matrices (banded / block-diagonal, e.g. capacity-expansion
    models) tile compactly; ``scipy_to_device_op`` falls back to
    ``torch.sparse`` when tiling would blow up memory.

    Tiles are kept twice, once in row-major tile order (forward) and once in
    column-major order, pre-transposed (transpose apply), so both directions
    see sorted output-block ids; ``row_ptr`` / ``row_ptrT`` are the offsets of
    each output block's tiles. The six arrays
    ``tiles, row_ids, col_ids, tilesT, row_idsT, col_idsT`` equal those of
    the JAX package's ``BSRMat`` for the same matrix; ``matmat`` /
    ``rmatmat`` use them.

    ``route`` says how ``op @ x`` and ``op.T @ y`` run. It is chosen once,
    from the layout and not the device, by the bytes the two directions'
    arrays hold: ``"csr"`` when the ``nnz`` non-zeros as compressed rows
    (derived from the tiles for A and for A^T: ``csr``, ``csrT``) weigh
    less than the dense tiles, as for the sparse energy-planning LPs, and
    ``"tiles"`` otherwise, for block-dense operators. On CPU tensors the
    route's plain version runs.

    ``op @ x`` and ``op.T @ y`` are differentiable in the vector; the
    backward of one direction is the other direction's apply on the same
    route. The matrix is data and gets no gradient.
    """

    def __init__(self, A: sp.spmatrix, bm: int = 128, bn: int = 128,
                 dtype=torch.float32, device="cuda"):
        A = sp.csr_matrix(A)
        m, n = A.shape
        Nb = -(-n // bn)
        coo = A.tocoo()
        tile_of = (coo.row // bm).astype(np.int64) * Nb + (coo.col // bn)
        uniq, inv = np.unique(tile_of, return_inverse=True)
        tiles = np.zeros((len(uniq), bm, bn), np.float64)
        tiles[inv, coo.row % bm, coo.col % bn] = coo.data
        row_ids = (uniq // Nb).astype(np.int32)
        col_ids = (uniq % Nb).astype(np.int32)
        perm = np.lexsort((col_ids, row_ids))
        tiles, row_ids, col_ids = tiles[perm], row_ids[perm], col_ids[perm]
        permT = np.lexsort((row_ids, col_ids))
        self._set(tiles, row_ids, col_ids, tiles[permT].transpose(0, 2, 1),
                  row_ids[permT], col_ids[permT], (m, n), bm, bn, coo.nnz, dtype, device)

    def _set(self, tiles, row_ids, col_ids, tilesT, row_idsT, col_idsT, shape,
             bm, bn, nse, dtype, device):
        dev = resolve_device(device)
        m, n = shape
        self.shape = (m, n)
        self.bm, self.bn = bm, bn
        self.Mb = -(-m // bm)
        self.Nb = -(-n // bn)
        self.nse = nse
        self.n_tiles = tiles.shape[0]
        put = lambda a, dt: torch.from_numpy(np.array(a, order="C")).to(device=dev, dtype=dt)
        self.tiles = put(tiles, dtype)
        self.row_ids = put(row_ids, torch.int32)
        self.col_ids = put(col_ids, torch.int32)
        self.tilesT = put(tilesT, dtype)
        self.row_idsT = put(row_idsT, torch.int32)
        self.col_idsT = put(col_idsT, torch.int32)
        self.row_ptr = put(_row_ptr(np.asarray(row_ids), self.Mb), torch.int32)
        self.row_ptrT = put(_row_ptr(np.asarray(col_idsT), self.Nb), torch.int32)
        indptr, indices, values = _compressed_rows(tiles, row_ids, col_ids, bm, bn, m)
        self.nnz = values.size
        item = self.tiles.element_size()
        tile_bytes = 2 * self.n_tiles * bm * bn * item
        csr_bytes = 2 * self.nnz * (item + 4) + (m + n + 2) * 4
        self.route = "csr" if csr_bytes < tile_bytes else "tiles"
        if self.route == "csr":
            indptrT, indicesT, valuesT = _compressed_rows(tilesT, col_idsT, row_idsT, bn, bm, n)
            self.csr = (put(indptr, torch.int32), put(indices, torch.int32),
                        put(values, dtype), kernels.csr_split(indptr, dev))
            self.csrT = (put(indptrT, torch.int32), put(indicesT, torch.int32),
                         put(valuesT, dtype), kernels.csr_split(indptrT, dev))

    @property
    def dtype(self):
        return self.tiles.dtype

    @property
    def device(self):
        return self.tiles.device

    def nbytes(self):
        # x2: tiles are stored twice (forward + pre-transposed)
        return 2 * self.n_tiles * self.bm * self.bn * self.tiles.element_size()

    def _apply(self, v, transposed: bool):
        """A @ v, or A^T @ v, through the route's kernel."""
        if self.route == "csr":
            indptr, indices, values, split = self.csrT if transposed else self.csr
            return kernels.csr_matvec(indptr, indices, values, v.contiguous(), split)
        m, n = self.shape
        if transposed:
            tiles, idx_in, idx_out, ptr = self.tilesT, self.row_idsT, self.col_idsT, self.row_ptrT
            n_in, b_in, n_out, length = self.Mb, self.bm, self.Nb, n
        else:
            tiles, idx_in, idx_out, ptr = self.tiles, self.col_ids, self.row_ids, self.row_ptr
            n_in, b_in, n_out, length = self.Nb, self.bn, self.Mb, m
        pad = n_in * b_in - v.shape[0]
        vb = (F.pad(v, (0, pad)) if pad else v.contiguous()).reshape(n_in, b_in)
        out = kernels.bsr_matvec(tiles, idx_in, idx_out, vb, n_out, row_ptr=ptr)
        return out.reshape(-1)[:length]

    def _differentiable_apply(self, v, transposed: bool):
        if torch.is_grad_enabled() and v.requires_grad:
            return _BSRApply.apply(self, transposed, v)
        return self._apply(v, transposed)  # no graph to record: skip the Function

    def matvec(self, x):
        return self._differentiable_apply(x, False)

    def rmatvec(self, y):
        return self._differentiable_apply(y, True)

    def _blocks_product(self, V, transposed: bool):
        m, n = self.shape
        if transposed:
            tiles, idx_in, ptr = self.tilesT, self.row_idsT, self.row_ptrT
            n_in, b_in, length = self.Mb, self.bm, n
        else:
            tiles, idx_in, ptr = self.tiles, self.col_ids, self.row_ptr
            n_in, b_in, length = self.Nb, self.bn, m
        S = V.shape[1]
        Vb = F.pad(V, (0, 0, 0, n_in * b_in - V.shape[0])).reshape(n_in, b_in, S)
        prod = torch.bmm(tiles, Vb[idx_in.long()])  # (T, b_out, S)
        # each output block's tile products added in tile order, on the card
        # too (index_add adds them with atomics there, in any order)
        out = torch.segment_reduce(prod, "sum", offsets=ptr, axis=0, unsafe=True)
        return out.reshape(-1, S)[:length]

    def matmat(self, X):
        """A @ X for X (n, S): one batched tile product (T, bm, bn) x
        (T, bn, S) and a sum into the output blocks in tile order, in the
        tiles' dtype, so two calls give the same bits (the
        multi-right-hand-side apply of the scenario-consensus path)."""
        return self._blocks_product(X, False)

    def rmatmat(self, Y):
        """A^T @ Y for Y (m, S) via the pre-transposed tiles."""
        return self._blocks_product(Y, True)

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def T(self):
        return _BSRTranspose(self)


class _BSRApply(torch.autograd.Function):
    """``op @ v`` (or ``op.T @ v``) whose cotangent is the other direction's
    apply, itself differentiable the same way. Gradients with respect to the
    matrix entries are not needed: LP constraint matrices are data, only the
    solver's hyperparameters learn."""

    @staticmethod
    def forward(ctx, op, transposed, v):
        ctx.op, ctx.transposed = op, transposed
        return op._apply(v, transposed)

    @staticmethod
    def backward(ctx, g):
        return None, None, _BSRApply.apply(ctx.op, not ctx.transposed, g)


class _BSRTranspose:
    def __init__(self, base: BSRMat):
        self.base = base
        self.shape = (base.shape[1], base.shape[0])
        self.nse = base.nse

    def __matmul__(self, y):
        return self.base.rmatvec(y)


class SparseOp:
    """A ``torch.sparse`` COO matrix as an operator: ``op @ x`` for 1-D or
    2-D dense ``x``, differentiable in ``x``."""

    def __init__(self, A: torch.Tensor):
        self.A = A
        self.shape = tuple(A.shape)
        self.nse = A._nnz()

    def __matmul__(self, x):
        if x.ndim == 1:
            return torch.sparse.mm(self.A, x[:, None])[:, 0]
        return torch.sparse.mm(self.A, x)


def bsr_from_numpy(arrays, shape, bm: int = 128, bn: int = 128, dtype=None,
                   device="cuda") -> BSRMat:
    """A ``BSRMat`` from the six arrays ``(tiles, row_ids, col_ids, tilesT,
    row_idsT, col_idsT)`` of one built elsewhere (the JAX package's, as
    numpy), so that two implementations run on the same operator. ``dtype``
    defaults to the tiles' own."""
    tiles, row_ids, col_ids, tilesT, row_idsT, col_idsT = (np.asarray(a) for a in arrays)
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, tiles.dtype)).dtype
    op = BSRMat.__new__(BSRMat)
    op._set(tiles, row_ids, col_ids, tilesT, row_idsT, col_idsT, tuple(shape), bm, bn,
            int(np.count_nonzero(tiles)), dtype, device)
    return op


def lp_params_from_numpy(params: dict, dtype=None, device="cuda") -> dict:
    """Solver hyperparameters (the five of ``LPSolverADMM`` or the four of
    ``ConsensusLPSolver``) given as numpy or Python scalars -> 0-d tensors."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def scipy_to_device_op(A: sp.spmatrix, dtype=torch.float32, bm: int = 128,
                       bn: int = 128, tile_budget_bytes: Optional[int] = None,
                       device="cuda"):
    """(op, op_T) device operators: BSR tiles when they fit the budget
    (structured matrices), else ``torch.sparse`` (worst-case random
    sparsity, where tiling would materialize ~nnz dense tiles).
    ``DPROX_LP_TILE_BUDGET`` overrides the byte budget (default 256 MiB)."""
    if tile_budget_bytes is None:
        tile_budget_bytes = int(os.environ.get("DPROX_LP_TILE_BUDGET", 1 << 28))
    probe = sp.coo_matrix(A)
    tile_of = (probe.row // bm).astype(np.int64) * (-(-A.shape[1] // bn)) \
        + (probe.col // bn)
    T = len(np.unique(tile_of))
    # budget the real footprint: both tile copies at the requested dtype
    itemsize = torch.empty((), dtype=dtype).element_size()
    if 2 * T * bm * bn * itemsize <= tile_budget_bytes:
        op = BSRMat(A, bm=bm, bn=bn, dtype=dtype, device=device)
        return op, op.T
    return scipy_to_bcoo(A, dtype, device=device)


def scipy_to_bcoo(A: sp.spmatrix, dtype=torch.float64, device="cuda"):
    """CSR/COO scipy matrix -> (A, A^T) ``torch.sparse`` COO operators."""
    dev = resolve_device(device)

    def coo(M):
        M = sp.coo_matrix(M)
        idx = torch.as_tensor(np.stack([M.row, M.col]).astype(np.int64))
        val = torch.as_tensor(M.data).to(dtype)
        return SparseOp(torch.sparse_coo_tensor(idx, val, M.shape, check_invariants=True).coalesce().to(dev))

    return coo(A), coo(A.T)

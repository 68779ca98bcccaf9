"""The port's CUDA kernels on the card: each held against its plain
PyTorch version, the wrappers' refusals, and the slice on CUDA against
the slice on the CPU.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); every
test skips without one. On the card, where JAX need not be installed:
    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import dprox_tpu_torch as dp
from dprox_tpu_torch.ops import kernels
from dprox_tpu_torch.utils import imaging

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.parametrize("shape,iterations,per_plane", [
    ((3, 512, 512), 10, False), ((1, 37, 53), 10, False), ((2, 130, 257), 10, True),
    ((4, 2, 70), 3, True), ((1, 33, 2), 1, False), ((2, 64, 96), 30, False)])
def test_tv_kernel_matches_plain(cuda, shape, iterations, per_plane):
    """Same float32 op order, no contraction: bit for bit (and so within
    1e-5)."""
    rng = np.random.RandomState(0)
    y = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)
    lam = torch.from_numpy((0.02 + 0.1 * rng.rand(shape[0] if per_plane else 1))
                           .astype(np.float32)).to(cuda)
    before = kernels.tv_denoise_chw.launches
    got = kernels.tv_denoise_chw(y, lam, iterations)
    assert kernels.tv_denoise_chw.launches == before + 1
    ref = kernels.tv_denoise_chw_plain(y, lam, iterations)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5
    assert torch.equal(got, ref)


# the paths' shapes (flagship 3x512x512 at 10 iterations, B and B' 3x256x256
# at 5), widths on both sides of one and two 128-column windows, heights on
# both sides of the 32- and 96-row windows (and of 64), one and two planes, lam per
# plane, and 1..44 iterations (44: the largest count a shared-memory window
# of 4 (32 + 2R)^2 floats took in 227 KB)
TV_WINDOW_CASES = [
    ((3, 512, 512), 10, False), ((3, 256, 256), 5, False), ((1, 31, 127), 1, False),
    ((2, 32, 128), 5, True), ((1, 33, 129), 10, False), ((2, 63, 257), 10, True),
    ((1, 64, 128), 31, False), ((2, 65, 129), 44, True), ((1, 95, 127), 5, False),
    ((2, 96, 257), 10, True), ((1, 97, 128), 44, False), ((2, 130, 257), 31, True)]


@pytest.mark.parametrize("shape,iterations,per_plane", TV_WINDOW_CASES)
def test_tv_kernel_every_window_equals_plain_bit_for_bit(cuda, shape, iterations, per_plane):
    """Each window the count fits (kernels.TV_WINDOWS) and the one the
    kernel picks give the plain version's bits; so do a second call and a
    CUDA-graph replay; one launch a call."""
    rng = np.random.RandomState(12)
    y = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)
    lam = torch.from_numpy((0.02 + 0.1 * rng.rand(shape[0] if per_plane else 1))
                           .astype(np.float32)).to(cuda)
    ref = kernels.tv_denoise_chw_plain(y, lam, iterations)
    before = kernels.tv_denoise_chw.launches
    got = kernels.tv_denoise_chw(y, lam, iterations)
    assert kernels.tv_denoise_chw.launches == before + 1
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5
    assert torch.equal(got, ref)
    assert torch.equal(got, kernels.tv_denoise_chw(y, lam, iterations))
    assert torch.equal(got, _replayed(lambda: kernels.tv_denoise_chw(y, lam, iterations)))
    fits = [i for i, (warps, rows) in enumerate(kernels.TV_WINDOWS)
            if warps * rows - 2 * iterations >= 1]
    assert kernels.tv_window(*shape, iterations) in fits
    for i in fits:
        assert torch.equal(kernels._tv_launch(y, lam, iterations, i), ref), i


def test_tv_kernel_takes_1_to_44_iterations_in_one_launch(cuda):
    assert kernels.tv_max_iterations() >= 44
    assert kernels.tv_window(3, 512, 512, 10) >= 0 and kernels.tv_window(3, 256, 256, 5) >= 0
    with pytest.raises(ValueError):
        kernels._tv_launch(torch.rand(1, 8, 8, device=cuda), torch.ones(1, device=cuda), 40, 0)


@pytest.mark.parametrize("fshape,dshape,rshape,strided", [
    ((1, 3, 512, 512), (1, 3, 512, 512), (), False),
    ((2, 3, 64, 80), (1, 3, 64, 80), (2, 1, 1, 1), False),
    ((2, 1, 33, 17), (), (2, 1, 1, 1), True),
    ((1, 3, 64, 33), (1, 3, 64, 64), (1,), False),  # half-spectrum slice of diag
])
def test_freq_divide_kernel_matches_plain(cuda, fshape, dshape, rshape, strided):
    rng = np.random.RandomState(1)
    F = torch.from_numpy((rng.randn(*fshape) + 1j * rng.randn(*fshape))
                         .astype(np.complex64)).to(cuda)
    if strided:
        F = F.transpose(-1, -2).contiguous().transpose(-1, -2)
    diag = torch.from_numpy(np.asarray(rng.rand(*dshape), np.float32)).to(cuda)
    if diag.ndim and diag.shape[-1] != fshape[-1]:
        diag = diag[..., :fshape[-1]]
    rho = torch.from_numpy(np.asarray(1e-3 * (1 + rng.rand(*rshape)), np.float32)).to(cuda)
    before = kernels.freq_divide.launches
    got = kernels.freq_divide(F, diag, rho)
    assert kernels.freq_divide.launches == before + 1
    ref = kernels.freq_divide_plain(F, diag, rho)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


ROW_SHAPES = [(1, 3, 512, 512), (1, 3, 256, 256), (2, 3, 37, 53), (4, 1, 7, 9),
              (2, 5000), (1, 3)]


def _randn(rng, shape, device):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("kind", ["nonneg", "soft"])
@pytest.mark.parametrize("shape", ROW_SHAPES)
@pytest.mark.parametrize("per_batch", [False, True])
def test_fused_admm_update_kernel_equals_plain(cuda, kind, shape, per_batch):
    """Same float32 operations in the same order, no contraction: exact."""
    rng = np.random.RandomState(2)
    Kx, u = _randn(rng, shape, cuda), _randn(rng, shape, cuda)
    Kx.view(-1)[:3] = torch.tensor([0.0, float("nan"), float("inf")], device=cuda)
    u.view(-1)[:3] = 0.0
    lam = torch.from_numpy((0.1 + rng.rand(shape[0] if per_batch else 1))
                           .astype(np.float32)).to(cuda)
    before = kernels.fused_admm_update.launches
    v, u_new = kernels.fused_admm_update(Kx, u, lam, kind)
    assert kernels.fused_admm_update.launches == before + 1
    v_ref, u_ref = kernels.fused_admm_update_plain(Kx, u, lam, kind)
    torch.cuda.synchronize()
    assert torch.equal(v.nan_to_num(nan=7.0), v_ref.nan_to_num(nan=7.0))
    assert torch.equal(u_new.nan_to_num(nan=7.0), u_ref.nan_to_num(nan=7.0))
    assert float(v.view(-1)[0]) == 0.0 and bool(torch.isnan(v.view(-1)[1]))


@pytest.mark.parametrize("lam", [None, 0.1, "per_pixel_float64"])
def test_fused_admm_update_nonneg_reads_no_lam(cuda, lam):
    """The generic nonneg prox ignores lam whatever it is; so does the
    kernel's nonneg kind (its soft kind checks lam)."""
    rng = np.random.RandomState(6)
    Kx, u = _randn(rng, (2, 3, 37, 53), cuda), _randn(rng, (2, 3, 37, 53), cuda)
    if lam == "per_pixel_float64":
        lam = torch.rand(Kx.shape, dtype=torch.float64, device=cuda)
    before = kernels.fused_admm_update.launches
    v, u_new = kernels.fused_admm_update(Kx, u, lam, "nonneg")
    assert kernels.fused_admm_update.launches == before + 1
    v_ref, u_ref = kernels.fused_admm_update_plain(Kx, u, lam, "nonneg")
    torch.cuda.synchronize()
    assert torch.equal(v, v_ref) and torch.equal(u_new, u_ref)


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_bdot_kernel_matches_plain_and_is_deterministic(cuda, shape):
    """float32 sums in another order than torch.sum: relative 1e-5 of
    sum |p q|; two calls give the same bits (no atomics)."""
    rng = np.random.RandomState(3)
    p, q = _randn(rng, shape, cuda), _randn(rng, shape, cuda)
    before = kernels.bdot.launches
    got = kernels.bdot(p, q)
    assert kernels.bdot.launches == before + 1
    again = kernels.bdot(p, q)
    ref = kernels.bdot_plain(p, q)
    exact = (p.double() * q.double()).flatten(1).sum(1)
    scale = (p * q).abs().flatten(1).sum(1).double()
    torch.cuda.synchronize()
    assert got.shape == (shape[0],) and torch.equal(got, again)
    assert bool(((got.double() - ref.double()).abs() <= 1e-5 * scale).all())
    assert bool(((got.double() - exact).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_fused_cg_tail_kernel_matches_plain(cuda, shape):
    """alpha, beta and rs' come from differently ordered float32 sums and
    scale whole arrays: relative 1e-5 of each output's largest value."""
    rng = np.random.RandomState(4)
    x, r, p = (_randn(rng, shape, cuda) for _ in range(3))
    Ap = p * 1.5 + 0.1 * _randn(rng, shape, cuda)  # <p, Ap> > 0, as for an SPD A
    rs = kernels.bdot_plain(r, r)
    before = kernels.fused_cg_tail.launches
    got = kernels.fused_cg_tail(x, r, p, Ap, rs)
    assert kernels.fused_cg_tail.launches == before + 1
    again = kernels.fused_cg_tail(x, r, p, Ap, rs)
    ref = kernels.fused_cg_tail_plain(x, r, p, Ap, rs)
    torch.cuda.synchronize()
    for g, a, e in zip(got, again, ref):
        assert g.shape == e.shape and torch.equal(g, a)
        assert float((g - e).abs().max()) <= 1e-5 * float(e.abs().max())


def test_fused_cg_tail_clamps_and_batch_independence(cuda):
    """Row 0: Ap = 0, so <p, Ap> = 0 and alpha = rs / 1e-32; row 1: a
    converged element (r = p = 0, rs = 0), which must stay put; row 2: an
    ordinary element, equal to the same element run alone."""
    rng = np.random.RandomState(5)
    shape = (3, 3, 16, 20)
    x, r, p = (_randn(rng, shape, cuda) for _ in range(3))
    Ap = p * 2.0
    Ap[0] = 0.0
    r[0] *= 1e-18
    r[1] = 0.0
    p[1] = 0.0
    rs = kernels.bdot_plain(r, r)
    got = kernels.fused_cg_tail(x, r, p, Ap, rs)
    ref = kernels.fused_cg_tail_plain(x, r, p, Ap, rs)
    alone = kernels.fused_cg_tail(x[2:], r[2:], p[2:], Ap[2:], rs[2:])
    torch.cuda.synchronize()
    for g, e, a in zip(got, ref, alone):
        assert bool(torch.isfinite(g).all())
        assert float((g - e).abs().max()) <= 1e-5 * float(e.abs().max())
        assert torch.equal(g[2:], a)
    assert torch.equal(got[0][1], x[1]) and float(got[3][1]) == 0.0
    assert float(got[2][1].abs().max()) == 0.0


def _replayed(fn):
    """``fn()``'s outputs after one capture of it in a CUDA graph and one
    replay (after a warm-up call outside the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _unaligned(t):
    """A contiguous copy of ``t`` whose base is one element past a 16-byte
    boundary (the kernels then read element by element)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


# path C's rows (8208 and 32784 LP variables), the float64 and consensus
# LP rows, one element, a row shorter than a group, the longest float32
# row of one block and the shortest of two launches, and a ragged row over
# many blocks
BDOT_SHAPES = [(1, 8208), (1, 32784), (1, 520), (8, 520), (1, 1), (1, 7), (2, 4097),
               (2, 10240), (2, 10241), (3, 50001)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", BDOT_SHAPES)
def test_bdot_rows_alone_unaligned_and_replayed_give_the_same_bits(cuda, shape, dtype, tol):
    """Within 1e-5 (float32) / 1e-12 (float64) of sum |p q| of the plain
    version; one counted launch a call; each row equals that row run alone, an
    unaligned copy of the operands, a second call and a CUDA-graph replay
    bit for bit (the summation order depends only on D)."""
    rng = np.random.RandomState(9)
    p, q = (torch.from_numpy(rng.randn(*shape)).to(device=cuda, dtype=dtype) for _ in range(2))
    before = kernels.bdot.launches
    got = kernels.bdot(p, q)
    assert kernels.bdot.launches == before + 1
    ref = kernels.bdot_plain(p, q)
    scale = (p * q).abs().flatten(1).sum(1).double()
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (shape[0],)
    assert bool(((got.double() - ref.double()).abs() <= tol * scale).all())
    assert torch.equal(got, kernels.bdot(p, q))
    assert torch.equal(got, kernels.bdot(_unaligned(p), _unaligned(q)))
    assert torch.equal(got, _replayed(lambda: kernels.bdot(p, q)))
    for i in range(shape[0]):
        assert torch.equal(got[i:i + 1], kernels.bdot(p[i:i + 1], q[i:i + 1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bdot_takes_more_rows_than_a_grid_dimension_of_65535(cuda, dtype):
    """70 000 rows of 8: the rows lie along grid x."""
    rng = np.random.RandomState(10)
    p, q = (torch.from_numpy(rng.randn(70000, 8)).to(device=cuda, dtype=dtype)
            for _ in range(2))
    got = kernels.bdot(p, q)
    exact = (p.double() * q.double()).sum(1)
    scale = (p * q).abs().sum(1).double()
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert got.shape == (70000,) and bool(((got.double() - exact).abs() <= tol * scale).all())
    assert torch.equal(got[69999:], kernels.bdot(p[69999:], q[69999:]))


# 1x3x256x256 (path B), 1x3x512x512 (a thread takes more groups than it
# loads at once), two blocks with a ragged last group, one element, and
# 70 000 rows along grid x
TAIL_SHAPES = [(1, 3, 256, 256), (1, 3, 512, 512), (2, 12290), (3, 1), (70000, 8)]


@pytest.mark.parametrize("shape", TAIL_SHAPES)
def test_fused_cg_tail_unaligned_and_replayed_give_the_same_bits(cuda, shape):
    """Within 1e-5 of each output's largest value of the plain version; one
    counted call; an unaligned copy of every operand, a second call and a
    CUDA-graph replay give the same bits; the last row equals itself run
    alone."""
    rng = np.random.RandomState(11)
    x, r, p = (_randn(rng, shape, cuda) for _ in range(3))
    Ap = p * 1.5 + 0.1 * _randn(rng, shape, cuda)
    rs = kernels.bdot_plain(r, r)
    before = kernels.fused_cg_tail.launches
    got = kernels.fused_cg_tail(x, r, p, Ap, rs)
    assert kernels.fused_cg_tail.launches == before + 1
    ref = kernels.fused_cg_tail_plain(x, r, p, Ap, rs)
    again = kernels.fused_cg_tail(x, r, p, Ap, rs)
    shifted = kernels.fused_cg_tail(*(_unaligned(t) for t in (x, r, p, Ap)), rs)
    replayed = _replayed(lambda: kernels.fused_cg_tail(x, r, p, Ap, rs))
    alone = kernels.fused_cg_tail(x[-1:], r[-1:], p[-1:], Ap[-1:], rs[-1:])
    torch.cuda.synchronize()
    for g, e, a, s, rp, al in zip(got, ref, again, shifted, replayed, alone):
        assert g.shape == e.shape and bool(torch.isfinite(g).all())
        assert float((g - e).abs().max()) <= 1e-5 * float(e.abs().max())
        assert torch.equal(g, a) and torch.equal(g, s) and torch.equal(g, rp)
        assert torch.equal(g[-1:], al)


def test_solver_kernels_raise_on_what_they_do_not_take(cuda):
    a = torch.rand(2, 3, 8, 8, device=cuda)
    lam = torch.full((1,), 0.1, device=cuda)
    bad = a.to(torch.complex64)  # no path hands these kernels a complex tensor
    with pytest.raises(NotImplementedError, match="takes no complex tensor"):
        kernels.bdot(bad, bad)
    with pytest.raises(NotImplementedError, match="takes no complex tensor"):
        kernels.fused_admm_update(bad, bad, lam)
    with pytest.raises(NotImplementedError, match="takes no complex tensor"):
        kernels.fused_cg_tail(bad, bad, bad, bad, torch.ones(2, device=cuda))
    bad = a.double()  # float64: bdot takes it, the other two say they do not
    assert kernels.bdot(bad, bad).dtype == torch.float64
    with pytest.raises(NotImplementedError, match="fused_admm_update CUDA kernel takes float32"):
        kernels.fused_admm_update(bad, bad, lam)
    with pytest.raises(NotImplementedError, match="fused_cg_tail CUDA kernel takes float32"):
        kernels.fused_cg_tail(bad, bad, bad, bad, torch.ones(2, device=cuda))
    with pytest.raises(TypeError):
        kernels.bdot(a, a.double())  # mixed dtypes
    with pytest.raises(TypeError):
        kernels.bdot(a.half(), a.half())
    with pytest.raises(ValueError):
        kernels.bdot(a, a[:, :, :4])
    with pytest.raises(ValueError):
        kernels.bdot(a.transpose(2, 3), a.transpose(2, 3))
    with pytest.raises(ValueError):
        kernels.bdot(a, a.cpu())
    with pytest.raises(ValueError):
        kernels.fused_admm_update(a, a, lam, kind="l2")
    with pytest.raises(ValueError):
        kernels.fused_admm_update(a, a, torch.full((3,), 0.1, device=cuda), kind="soft")
    with pytest.raises(TypeError):
        kernels.fused_admm_update(a, a, 0.1, kind="soft")  # host float scalar
    with pytest.raises(ValueError):
        kernels.fused_cg_tail(a, a, a, a, torch.ones(3, device=cuda))


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_bdot_float64_kernel_matches_plain(cuda, shape):
    """float64 sums in another order: 1e-12 of sum |p q|; same bits twice."""
    rng = np.random.RandomState(7)
    p, q = (torch.from_numpy(rng.randn(*shape)).to(cuda) for _ in range(2))
    before = kernels.bdot.launches
    got, again = kernels.bdot(p, q), kernels.bdot(p, q)
    assert kernels.bdot.launches == before + 2
    ref = kernels.bdot_plain(p, q)
    scale = (p * q).abs().flatten(1).sum(1)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == (shape[0],) and torch.equal(got, again)
    assert bool(((got - ref).abs() <= 1e-12 * scale).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bdot_on_cuda_is_differentiable(cuda, dtype):
    """d<p, q>/dp = q and d/dq = p per row, through the kernel's forward."""
    rng = np.random.RandomState(8)
    p, q = (torch.from_numpy(rng.randn(3, 5, 7)).to(device=cuda, dtype=dtype).requires_grad_()
            for _ in range(2))
    w = torch.tensor([1.0, -2.0, 0.5], device=cuda, dtype=dtype)
    before = kernels.bdot.launches
    gp, gq = torch.autograd.grad((kernels.bdot(p, q) * w).sum(), (p, q))
    assert kernels.bdot.launches == before + 1
    assert torch.equal(gp, w.reshape(3, 1, 1) * q.detach())
    assert torch.equal(gq, w.reshape(3, 1, 1) * p.detach())
    with torch.no_grad():
        assert not kernels.bdot(p, q).requires_grad


def _bsr_operator(cuda, shape, dtype, bm, bn, density=0.05, seed=3):
    import scipy.sparse as sp

    from dprox_tpu_torch.algo.lp import BSRMat

    A = sp.random(*shape, density=density, random_state=np.random.RandomState(seed), format="csr")
    return A, BSRMat(A, bm=bm, bn=bn, dtype=dtype, device=cuda)


BSR_CASES = [((70, 33), 128, 128), ((256, 300), 128, 128), ((13, 513), 128, 128),
             ((1000, 700), 128, 128), ((150, 90), 32, 16), ((90, 150), 16, 48),
             ((200, 100), 5, 7), ((300, 40), 200, 33)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape,bm,bn", BSR_CASES)
def test_bsr_matvec_kernel_matches_plain_and_scipy(cuda, shape, bm, bn, dtype, tol):
    """Both directions; sums in another order than the plain version's:
    1e-5 (float32) / 1e-12 (float64) of the largest entry; same bits twice."""
    A, op = _bsr_operator(cuda, shape, dtype, bm, bn)
    rng = np.random.RandomState(0)
    for tiles, idx_in, idx_out, ptr, n_in, n_out, M in (
            (op.tiles, op.col_ids, op.row_ids, op.row_ptr, op.Nb, op.Mb, A),
            (op.tilesT, op.row_idsT, op.col_idsT, op.row_ptrT, op.Mb, op.Nb, A.T)):
        x = torch.from_numpy(rng.rand(n_in, tiles.shape[2])).to(device=cuda, dtype=dtype)
        before = kernels.bsr_matvec.launches
        got = kernels.bsr_matvec(tiles, idx_in, idx_out, x, n_out, row_ptr=ptr)
        again = kernels.bsr_matvec(tiles, idx_in, idx_out, x, n_out)  # derives row_ptr
        assert kernels.bsr_matvec.launches == before + 2
        ref = kernels.bsr_matvec_plain(tiles, idx_in, idx_out, x, n_out)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.equal(got, again)
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    x = rng.rand(shape[1])
    got = (op @ torch.from_numpy(x).to(device=cuda, dtype=dtype)).double().cpu().numpy()
    assert np.abs(got - A @ x).max() <= tol * np.abs(A @ x).max()
    y = rng.rand(shape[0])
    got = (op.T @ torch.from_numpy(y).to(device=cuda, dtype=dtype)).double().cpu().numpy()
    assert np.abs(got - A.T @ y).max() <= tol * np.abs(A.T @ y).max()


def test_bsr_matvec_empty_output_blocks_and_no_tiles(cuda):
    import scipy.sparse as sp

    from dprox_tpu_torch.algo.lp import BSRMat

    A = sp.lil_matrix((5 * 16, 3 * 16))
    A[0:3, 0:4] = 1.5
    A[70:75, 40:44] = -2.0
    op = BSRMat(A.tocsr(), bm=16, bn=16, dtype=torch.float32, device=cuda)
    x = torch.arange(48, dtype=torch.float32, device=cuda)
    out = op @ x
    assert float(out[16:64].abs().max()) == 0.0
    np.testing.assert_allclose(out.cpu().numpy(), A.tocsr() @ x.cpu().numpy(), rtol=1e-6)
    empty = BSRMat(sp.csr_matrix((40, 30)), bm=16, bn=16, dtype=torch.float32, device=cuda)
    before = kernels.bsr_matvec.launches
    assert torch.equal(empty @ torch.ones(30, device=cuda), torch.zeros(40, device=cuda))
    assert kernels.bsr_matvec.launches == before  # no tiles: zeros without a launch


def _arrow(n_blocks, b, seed=0):
    """Dense diagonal blocks and a dense first block column (b x b each)."""
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    grid = [[None] * n_blocks for _ in range(n_blocks)]
    for i in range(n_blocks):
        grid[i][i] = sp.csr_matrix(0.5 + rng.rand(b, b))
        if i:
            grid[i][0] = sp.csr_matrix(0.5 + rng.rand(b, b))
    return sp.bmat(grid, format="csr")


@pytest.mark.parametrize("route", ["csr", "tiles"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_bsr_backward_is_the_transposed_kernel(cuda, dtype, rtol, route):
    """grad of sum((A x)^2) = 2 A^T A x: one forward launch, one backward
    launch of the other direction, on the operator's route's kernel."""
    from dprox_tpu_torch.algo.lp import BSRMat

    if route == "csr":
        A, op = _bsr_operator(cuda, (40, 30), dtype, 16, 16, density=0.2, seed=1)
    else:
        A = _arrow(3, 16, seed=1)[:40, :30].tocsr()
        op = BSRMat(A, bm=16, bn=16, dtype=dtype, device=cuda)
    assert op.route == route
    counter = kernels.csr_matvec if route == "csr" else kernels.bsr_matvec
    x0 = np.random.RandomState(1).rand(30)
    x = torch.from_numpy(x0).to(device=cuda, dtype=dtype).requires_grad_()
    before = counter.launches
    g, = torch.autograd.grad(torch.sum((op @ x) ** 2), x)
    assert counter.launches == before + 2
    np.testing.assert_allclose(g.double().cpu().numpy(), 2 * A.T @ (A @ x0), rtol=rtol)
    y0 = np.random.RandomState(2).rand(40)
    y = torch.from_numpy(y0).to(device=cuda, dtype=dtype).requires_grad_()
    gT, = torch.autograd.grad(torch.sum((op.T @ y) ** 2), y)
    np.testing.assert_allclose(gT.double().cpu().numpy(), 2 * A @ (A.T @ y0), rtol=rtol)


def _csr_case(M, dtype, device):
    import scipy.sparse as sp

    M = sp.csr_matrix(M, copy=True)
    M.eliminate_zeros()
    M.sort_indices()
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)
    return put(M.indptr, torch.int32), put(M.indices, torch.int32), put(M.data, dtype)


def _long_rows(long=4500, seed=0):
    """Empty rows, rows of 1..16 (one thread each), 17..128 (one warp),
    129 and 1000 (one block), and a column of ``long`` (cut in the
    transpose beyond CSR_CHUNK, 4096); odd lengths, so nothing is a
    multiple of a block."""
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    m = max(5001, long + 501)
    A = sp.random(m, 1203, density=0.003, random_state=rng, format="lil")
    A[3, :] = 0.0
    for r, k in [(5, 16), (6, 17), (7, 128), (8, 129), (9, 1000)]:
        A[r, rng.choice(1203, k, replace=False)] = 0.5 + rng.rand(k)
    A[rng.choice(m, long, replace=False), 11] = 0.5 + rng.rand(long)[:, None]
    return sp.csr_matrix(A)


CSR_CASES = ["long rows", "longer rows", "random 70x33", "random 1000x700", "empty rows"]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-14)])
@pytest.mark.parametrize("case", CSR_CASES)
def test_csr_matvec_kernel_matches_plain(cuda, case, dtype, tol):
    """Both directions: rows summed by a thread, a warp, a block, and cut
    into two or three pieces that a second launch adds; relative 1e-6
    (float32) / 1e-14 (float64) of the largest entry against the plain
    version on float64 copies of the same inputs; the same bits twice; y
    at its length. Entries and x are positive, as the LP's products mostly
    are: a float64 sum of thousands of terms with cancellation drifts more
    than 1e-14 of the largest entry in any order."""
    import scipy.sparse as sp

    rng = np.random.RandomState(4)
    A = {"long rows": lambda: _long_rows(),
         "longer rows": lambda: _long_rows(9001, seed=1),
         "random 70x33": lambda: sp.random(70, 33, density=0.05, random_state=rng),
         "random 1000x700": lambda: sp.random(1000, 700, density=0.02, random_state=rng),
         "empty rows": lambda: sp.csr_matrix((np.ones(3), ([0, 0, 5], [1, 4, 2])), (9, 6)),
         }[case]()
    for M in (sp.csr_matrix(A), sp.csr_matrix(A.T)):
        indptr, indices, values = _csr_case(M, dtype, cuda)
        split = kernels.csr_split(indptr, cuda)
        x = torch.from_numpy(rng.rand(M.shape[1])).to(device=cuda, dtype=dtype)
        before = kernels.csr_matvec.launches
        got = kernels.csr_matvec(indptr, indices, values, x, split)
        again = kernels.csr_matvec(indptr, indices, values, x, split)
        assert kernels.csr_matvec.launches == before + 2
        ref = kernels.csr_matvec_plain(indptr, indices, values.double(), x.double(), split)
        exact = M @ x.double().cpu().numpy()
        torch.cuda.synchronize()
        assert got.shape == (M.shape[0],) and got.dtype == dtype and torch.equal(got, again)
        scale = max(float(ref.abs().max()), 1e-300)
        assert float((got.double() - ref).abs().max()) <= tol * scale
        assert np.abs(got.double().cpu().numpy() - exact).max() <= 100 * tol * scale
        if case == "empty rows":
            assert float(got[np.diff(M.indptr) == 0].abs().max()) == 0.0
        if case in ("long rows", "longer rows") and M.shape[0] == 1203:
            assert split.n_split == 1  # the long column


def test_csr_matvec_raises_on_what_it_does_not_take(cuda):
    import scipy.sparse as sp

    indptr, indices, values = _csr_case(sp.random(30, 20, density=0.2, random_state=0),
                                        torch.float32, cuda)
    x = torch.rand(20, device=cuda)
    split = kernels.csr_split(indptr, cuda)
    with pytest.raises(TypeError):
        kernels.csr_matvec(indptr, indices, values.half(), x.half(), split)
    with pytest.raises(TypeError):
        kernels.csr_matvec(indptr, indices, values, x.double(), split)
    with pytest.raises(TypeError):
        kernels.csr_matvec(indptr, indices.long(), values, x, split)
    with pytest.raises(ValueError):
        kernels.csr_matvec(indptr, indices, values, x.cpu(), split)
    with pytest.raises(ValueError):
        kernels.csr_matvec(indptr, indices, values, x[::2], split)
    with pytest.raises(ValueError):
        kernels.csr_matvec(indptr, indices, values[:-1], x, split)
    with pytest.raises(ValueError):
        kernels.csr_matvec(indptr[:-1].contiguous(), indices, values, x, split)
    with pytest.raises(ValueError, match="within x"):
        kernels.csr_matvec(indptr, indices, values, x[:5].contiguous())
    with pytest.raises(RuntimeError, match="csr_matvec kernel launch failed"):
        kernels.csr_matvec(indptr, indices, values, x, split._replace(n_split=1))
    with pytest.raises(NotImplementedError, match="takes no complex tensor"):
        kernels.csr_matvec(indptr, indices, values.to(torch.complex64), x, split)
    before = kernels.csr_matvec.launches
    empty = _csr_case(sp.csr_matrix((7, 20)), torch.float32, cuda)
    assert torch.equal(kernels.csr_matvec(*empty, x), torch.zeros(7, device=cuda))
    assert kernels.csr_matvec.launches == before  # no non-zeros: zeros without a launch


def test_matmat_rmatmat_give_the_same_bits_twice(cuda):
    """The scenario-batched applies add each output block's tile products
    in tile order (no index_add atomics): two calls, the same bits."""
    import scipy.sparse as sp

    from dprox_tpu_torch.algo.lp import BSRMat
    from dprox_tpu_torch.contrib.energy_system import synthetic_cep_model

    c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(512, 16)
    A = sp.vstack([A_ub, A_eq, sp.eye(c.shape[0])]).tocsr()
    op = BSRMat(A, dtype=torch.float32, device=cuda)
    rng = np.random.RandomState(6)
    X = torch.from_numpy(rng.randn(A.shape[1], 8).astype(np.float32)).to(cuda)
    Y = torch.from_numpy(rng.randn(A.shape[0], 8).astype(np.float32)).to(cuda)
    for f, V, M in ((op.matmat, X, A), (op.rmatmat, Y, A.T)):
        got, again = f(V), f(V)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        exact = M @ V.double().cpu().numpy()
        assert np.abs(got.double().cpu().numpy() - exact).max() <= 1e-5 * np.abs(exact).max()


def test_bsr_matvec_raises_on_what_it_does_not_take(cuda):
    _, op = _bsr_operator(cuda, (70, 33), torch.float32, 16, 16)
    x = torch.rand(op.Nb, 16, device=cuda)
    args = (op.tiles, op.col_ids, op.row_ids, x, op.Mb)
    with pytest.raises(TypeError):
        kernels.bsr_matvec(op.tiles.half(), *args[1:])
    with pytest.raises(TypeError):
        kernels.bsr_matvec(op.tiles, op.col_ids, op.row_ids, x.double(), op.Mb)
    with pytest.raises(TypeError):
        kernels.bsr_matvec(op.tiles, op.col_ids.long(), op.row_ids, x, op.Mb)
    with pytest.raises(ValueError):
        kernels.bsr_matvec(op.tiles, op.col_ids, op.row_ids, x[:, :8], op.Mb)
    with pytest.raises(ValueError):
        kernels.bsr_matvec(op.tiles, op.col_ids, op.row_ids, x.cpu(), op.Mb)
    with pytest.raises(ValueError):
        kernels.bsr_matvec(*args, row_ptr=op.row_ptr[:-1].contiguous())
    with pytest.raises(ValueError, match="sorted"):
        kernels.bsr_matvec(op.tiles, op.col_ids, op.row_ids.flip(0).contiguous(), x, op.Mb)
    with pytest.raises(ValueError, match="idx_in"):
        kernels.bsr_matvec(op.tiles, op.col_ids + op.Nb, op.row_ids, x, op.Mb)
    with pytest.raises(NotImplementedError, match="takes no complex tensor"):
        kernels.bsr_matvec(op.tiles.to(torch.complex64), *args[1:])


def test_lp_solve_on_cuda_matches_cpu(cuda):
    """The LP path on the card (kernels) against itself on the CPU (plain
    versions), float64: same iteration count, x to 1e-6."""
    from dprox_tpu_torch.algo import lp
    from dprox_tpu_torch.contrib.energy_system import synthetic_cep_model

    c, A_ub, A_eq, b_ub, b_eq = synthetic_cep_model(16, 4)
    out = {}
    for device in ("cpu", "cuda"):
        p = lp.LPProblem(c, A_ub, b_ub, A_eq, b_eq, dtype=torch.float64, device=device)
        kernels.reset_launches()
        x, res = lp.LPSolverADMM(verbose=False).solve_fused(p, max_iters=500)
        counts = kernels.launch_counts()
        assert p.A.route == "csr" and counts["bsr_matvec"] == 0
        assert (counts["csr_matvec"] > 0) == (device == "cuda")
        assert (counts["bdot"] > 0) == (device == "cuda")
        out[device] = (x.cpu().numpy(), res["iters"])
    assert out["cpu"][1] == out["cuda"][1]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-6)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    y = torch.rand(2, 16, 16, device=cuda)
    lam = torch.full((1,), 0.1, device=cuda)
    with pytest.raises(TypeError):
        kernels.tv_denoise_chw(y, 0.1, 5)  # host float scalar
    with pytest.raises(TypeError):
        kernels.tv_denoise_chw(y.double(), lam, 5)
    with pytest.raises(ValueError):
        kernels.tv_denoise_chw(y.transpose(1, 2), lam, 5)
    with pytest.raises(ValueError):
        kernels.tv_denoise_chw(y, torch.full((3,), 0.1, device=cuda), 5)
    with pytest.raises(ValueError):
        kernels.tv_denoise_chw(y, lam.cpu(), 5)
    with pytest.raises(ValueError):
        kernels.tv_denoise_chw(y, lam, kernels.tv_max_iterations() + 1)
    F = torch.zeros(1, 1, 8, 8, dtype=torch.complex64, device=cuda)
    rho = torch.ones((), device=cuda)
    with pytest.raises(TypeError):
        kernels.freq_divide(F.to(torch.complex128), torch.ones((), device=cuda), rho)
    with pytest.raises(TypeError):  # a complex divisor is complex64, like F
        kernels.freq_divide(F, torch.ones((), dtype=torch.complex128, device=cuda), rho)
    with pytest.raises(ValueError):
        kernels.freq_divide(F[0], torch.ones((), device=cuda), rho)
    with pytest.raises(RuntimeError):
        kernels.freq_divide(F, torch.ones(2, 8, device=cuda), rho)  # not broadcastable


def test_slice_on_cuda_matches_cpu(cuda):
    img = imaging._synthetic_face(512, 512)[224:288, 224:288]
    psf = imaging.point_spread_function(15, 5)
    b = imaging.blurring(dp.tensor(img, batch=True), psf)
    rhos, sigmas = dp.log_descent(80, 30, 8)
    outs = {}
    for device in ("cpu", "cuda"):
        x = dp.Variable()
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b),
                             dp.deep_prior(x, "distilled_color_tv")], "admm", device=device)
        kernels.reset_launches()
        outs[device] = solver.solve(x0=b, max_iter=8, rhos=rhos, lams=sigmas).cpu()
        expected = 8 if device == "cuda" else 0
        counts = kernels.launch_counts()
        assert (counts["tv_denoise_chw"], counts["freq_divide"]) == (expected, expected)
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 1e-4


def _rel(got, ref):
    """max |got - ref| / max |ref|, in float64."""
    got, ref = got.to(ref.dtype), ref
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def test_tv_gradient_is_the_backward_kernels_and_equals_the_plain_adjoint(cuda):
    """Under grad the forward is one launch of the kernel (the plain
    version's bits) and the backward one call of the backward kernel:
    d y0 is the plain adjoint's bits (tv_denoise_chw_vjp_plain, same op
    order), d lam within 1e-5 of the float64 adjoint's largest entry (a
    float32 sum in another order); an expanded cotangent (from ``sum``)
    is read in place; a double backward raises; without grad there is no
    graph."""
    rng = np.random.RandomState(13)
    y = torch.from_numpy(rng.rand(2, 37, 53).astype(np.float32)).to(cuda).requires_grad_()
    lam = torch.tensor([0.05, 0.08], device=cuda, requires_grad=True)
    g = torch.from_numpy(rng.randn(2, 37, 53).astype(np.float32)).to(cuda)
    for cot in (g, torch.ones((), device=cuda).expand(2, 37, 53)):
        before = kernels.launch_counts()
        out = kernels.tv_denoise_chw(y, lam, 10)
        got = torch.autograd.grad(out, (y, lam), cot)
        after = kernels.launch_counts()
        assert out.grad_fn is not None
        assert (after["tv_denoise_chw"] - before["tv_denoise_chw"],
                after["tv_denoise_chw_vjp"] - before["tv_denoise_chw_vjp"]) == (1, 1)
        assert torch.equal(out, kernels.tv_denoise_chw_plain(y.detach(), lam.detach(), 10))
        ref = kernels.tv_denoise_chw_vjp_plain(y.detach(), lam.detach(), 10, cot)
        ref64 = kernels.tv_denoise_chw_vjp_plain(y.detach(), lam.detach(), 10, cot.double())
        assert got[0].shape == ref[0].shape and torch.equal(got[0], ref[0])
        assert got[1].shape == lam.shape
        scale = max(float(ref64[0].abs().max()), float(ref64[1].abs().max()), 1e-30)
        assert float((got[1].double() - ref64[1]).abs().max()) <= 1e-5 * scale
    with pytest.raises(RuntimeError, match="double backward"):
        torch.autograd.grad(kernels.tv_denoise_chw(y, lam, 10), y, g, create_graph=True)
    with torch.no_grad():
        assert kernels.tv_denoise_chw(y, lam, 10).grad_fn is None


def _tv_inputs(shape, per_plane, kind, seed):
    """(y0, lam) on the card: a random image, or for "tie" a
    piecewise-constant one with lam = 0 (max and min tie where it is flat),
    or for "smooth" a random image with lam = 2 (few duals clip)."""
    rng = np.random.RandomState(seed)
    n = shape[0] if per_plane else 1
    if kind == "tie":
        blocks = rng.randint(0, 3, (shape[0], -(-shape[1] // 8), -(-shape[2] // 8)))
        y = np.kron(blocks, np.ones((1, 8, 8)))[:, :shape[1], :shape[2]]
        lam = np.zeros(n)
    elif kind == "smooth":
        y, lam = rng.rand(*shape), np.full(n, 2.0)
    else:
        y, lam = rng.rand(*shape), 0.02 + 0.1 * rng.rand(n)
    put = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to("cuda")
    return put(y), put(lam)


def _tv_forward_and_backward_in_every_window(y, lam, iterations, g):
    """The forward with its clip codes in every forward window the count
    fits and, from each, the backward in every backward window: the
    forward's and d y0's bits against the plain version and the plain
    adjoint, the codes alike in every forward window, d y0 within 1e-6 of
    its largest entry and d lam within 1e-5 of the gradient's largest
    entry of the adjoint run in float64 on the same branches (a float32 sum
    of 2 (iterations - 1) terms a cell in another order), a second call's
    bits, one count a call. Returns the last (codes, d y0, d lam)."""
    W = y.shape[-1]
    ref = kernels.tv_denoise_chw_plain(y, lam, iterations)
    rdy, _ = kernels.tv_denoise_chw_vjp_plain(y, lam, iterations, g)
    dy64, dlam64 = kernels.tv_denoise_chw_vjp_plain(y, lam, iterations, g.double())
    scale = max(float(dy64.abs().max()), float(dlam64.abs().max()), 1e-30)
    fits = [i for i, (warps, rows) in enumerate(kernels.TV_WINDOWS)
            if warps * rows - 2 * iterations >= 1]
    back = [i for i, (warps, rows) in enumerate(kernels.TV_VJP_WINDOWS)
            if warps * rows - 2 * (iterations - 1) >= 1]
    assert fits and back
    assert kernels.tv_vjp_window(*y.shape, iterations) in back
    first = None
    for i in fits + [-1]:
        out, codes = kernels._tv_launch(y, lam, iterations, i, codes=True)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), i
        if first is None:
            first = codes
        assert torch.equal(codes[..., :W], first[..., :W]), i
        for j in back + [-1]:
            before = kernels.tv_denoise_chw_vjp.launches
            dy, dlam = kernels._tv_vjp_launch(codes, lam, iterations, g, j)
            assert kernels.tv_denoise_chw_vjp.launches == before + 1
            torch.cuda.synchronize()
            assert dlam.shape == lam.shape and torch.equal(dy, rdy), (i, j)
            assert float((dy.double() - dy64).abs().max()) <= 1e-6 * float(
                dy64.abs().max()), (i, j)
            assert float((dlam.double() - dlam64).abs().max()) <= 1e-5 * scale, (i, j)
            again = kernels._tv_vjp_launch(codes, lam, iterations, g, j)
            assert torch.equal(again[0], dy) and torch.equal(again[1], dlam), (i, j)
    return codes, dy, dlam, dlam64


@pytest.mark.parametrize("shape,iterations,per_plane,kind",
                         [c + ("rand",) for c in TV_WINDOW_CASES]
                         + [((3, 64, 200), 10, False, "tie"), ((2, 40, 130), 5, True, "tie"),
                            ((3, 33, 2), 3, True, "rand"), ((1, 2, 70), 1, False, "rand"),
                            ((2, 100, 260), 10, True, "smooth")])
def test_tv_backward_kernel_matches_plain_adjoint(cuda, shape, iterations, per_plane, kind):
    """In every forward window the count fits and every backward window:
    the forward with its clip codes gives the plain version's bits; the
    backward gives the plain adjoint's bits for d y0 and, against the
    adjoint run in float64 on the same branches, d y0 within 1e-6 and d lam
    within 1e-5; two calls and a CUDA-graph replay give the same bits; lam
    once or once per plane; the tie case; "smooth" (lam 2: few duals clip,
    so an error at a window's edge reaches its output cells)."""
    y, lam = _tv_inputs(shape, per_plane, kind, seed=21)
    g = torch.from_numpy(np.random.RandomState(22).randn(*shape).astype(np.float32)).to(cuda)
    codes, dy, dlam, dlam64 = _tv_forward_and_backward_in_every_window(y, lam, iterations, g)
    replay = _replayed(lambda: kernels._tv_vjp_launch(codes, lam, iterations, g))
    assert torch.equal(replay[0], dy) and torch.equal(replay[1], dlam)
    if kind == "tie" and iterations > 1:
        assert float(dlam64.abs().max()) > 0  # the ties reach d lam


# heights and widths on both sides of each backward window's output
# rectangle (rows 32, 64, 96 less 2 (iterations - 1); columns 128 less a
# left halo of iterations - 1 rounded up to 4 and a right one of iterations
# - 1, rounded down to 4), at 1, 2, 10 and the largest iteration count
TV_VJP_EDGE_CASES = [
    ((1, 31, 127), 1), ((2, 33, 129), 1), ((1, 63, 128), 1), ((1, 97, 257), 1),
    ((1, 29, 119), 2), ((2, 31, 121), 2), ((1, 61, 240), 2), ((1, 63, 241), 2),
    ((1, 93, 120), 2), ((1, 95, 121), 2),
    ((1, 13, 103), 10), ((2, 15, 105), 10), ((1, 45, 208), 10), ((1, 47, 209), 10),
    ((3, 77, 104), 10), ((1, 79, 313), 10),
    ((1, 3, 31), 47), ((1, 5, 33), 47), ((2, 9, 65), 47)]


@pytest.mark.parametrize("shape,iterations", TV_VJP_EDGE_CASES)
def test_tv_backward_every_window_at_its_edges(cuda, shape, iterations):
    """Sizes on both sides of each backward window's output rectangle, lam
    per plane: every forward and backward window gives the plain version's
    and the plain adjoint's bits, a CUDA-graph replay too."""
    assert kernels.tv_max_iterations() == 47
    y, lam = _tv_inputs(shape, True, "rand", seed=25)
    g = torch.from_numpy(np.random.RandomState(26).randn(*shape).astype(np.float32)).to(cuda)
    codes, dy, dlam, _ = _tv_forward_and_backward_in_every_window(y, lam, iterations, g)
    replay = _replayed(lambda: kernels._tv_vjp_launch(codes, lam, iterations, g))
    assert torch.equal(replay[0], dy) and torch.equal(replay[1], dlam)


def test_tv_kernel_attributes_are_read_on_the_card(cuda):
    """Every TV kernel's registers (at most the card's 255), spill bytes
    and static shared bytes, as cudaFuncGetAttributes reports them."""
    attrs = kernels.tv_kernel_attributes()
    assert len(attrs) == 2 * len(kernels.TV_WINDOWS) + len(kernels.TV_VJP_WINDOWS)
    for name, a in attrs.items():
        assert 0 < a["registers"] <= 255 and a["local_bytes"] >= 0, (name, a)


def test_tv_backward_launches_only_the_ports_kernels(cuda):
    """A profiler trace of one backward at the joint paths' shape
    (3x256x256, 5 iterations) holds the backward kernel's two launches
    (every step, then the sum of d lam) and nothing else: no aten
    elementwise or cat kernel; the Python limit equals the library's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    assert kernels.tv_max_iterations() == kernels._lib("tv_denoise").dprox_tv_max_iterations()
    y, lam = _tv_inputs((3, 256, 256), False, "rand", seed=23)
    y.requires_grad_()
    g = torch.randn(3, 256, 256, device=cuda)
    torch.autograd.grad(kernels.tv_denoise_chw(y, lam, 5), y, g)  # warm
    out = kernels.tv_denoise_chw(y, lam, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, y, g)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith("Memset")]
    assert len(names) == 2 and all("tv_vjp" in n for n in names), names


def test_tv_backward_wrapper_refusals(cuda):
    y, lam = _tv_inputs((2, 16, 16), False, "rand", seed=24)
    _, codes = kernels._tv_launch(y, lam, 5, codes=True)
    g = torch.rand(2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="iterations"):
        kernels._tv_vjp_launch(codes, lam, 4, g)
    with pytest.raises(ValueError, match="shape"):
        kernels._tv_vjp_launch(codes, lam, 5, g[:, :8])
    assert codes.shape == (4, 2, 16, 16) and codes.dtype == torch.uint8
    with pytest.raises(TypeError):
        kernels._tv_vjp_launch(codes, lam, 5, g.double())
    with pytest.raises(ValueError):
        kernels._tv_vjp_launch(codes, torch.full((3,), 0.1, device=cuda), 5, g)
    dy, dlam = kernels.tv_denoise_chw_vjp(y, lam, 5, g)
    assert torch.equal(dy, kernels.tv_denoise_chw_vjp_plain(y, lam, 5, g)[0])


@pytest.mark.parametrize("rho_shape,diag_shape", [((), (1, 3, 32, 40)), ((2, 1, 1, 1), ()),
                                                  ((1,), (1, 1, 32, 40))])
def test_freq_divide_gradient_matches_plain(cuda, rho_shape, diag_shape):
    """Against autograd of the plain version on complex128 / float64 copies:
    relative 1e-5 of each gradient's largest entry (float32 against float64
    division, and sums over broadcast dims)."""
    rng = np.random.RandomState(14)
    shape = (2, 3, 32, 40)
    F = torch.from_numpy((rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64))
    diag = torch.from_numpy(np.asarray(rng.rand(*diag_shape), np.float32))
    rho = torch.from_numpy(np.asarray(1e-2 * (1 + rng.rand(*rho_shape)), np.float32))
    g = torch.from_numpy((rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64))
    ins = [t.to(cuda).requires_grad_() for t in (F, diag, rho)]
    out = kernels.freq_divide(*ins)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, g.to(cuda))
    ins64 = [t.to(cuda).to(torch.complex128 if t.is_complex() else torch.float64)
             .requires_grad_() for t in (F, diag, rho)]
    ref = torch.autograd.grad(kernels.freq_divide_plain(*ins64), ins64,
                              g.to(cuda).to(torch.complex128))
    for a, b in zip(got, ref):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5


@pytest.mark.parametrize("kind", ["nonneg", "soft"])
@pytest.mark.parametrize("per_batch", [False, True])
def test_fused_admm_update_gradient_matches_plain_at_ties(cuda, kind, per_batch):
    """Kx and u: the plain version's float32 autograd bit for bit, exact
    ties (w == 0 and |w| == lam) included, where a tie takes half; lam: a
    sum over the elements, relative 1e-5 of the float64 plain gradient."""
    rng = np.random.RandomState(15)
    shape = (2, 3, 16, 20)
    Kx, u = _randn(rng, shape, cuda), _randn(rng, shape, cuda)
    lam = torch.tensor([0.5, 0.25] if per_batch else [0.5], device=cuda)
    Kx[0, 0, 0, :4] = torch.tensor([0.0, 0.5, -0.5, 0.25], device=cuda)
    Kx[1, 0, 0, :3] = torch.tensor([0.0, 0.25 if per_batch else 0.5, -0.5], device=cuda)
    u[:, 0, 0, :4] = 0.0
    gv, gu = _randn(rng, shape, cuda), _randn(rng, shape, cuda)
    ins = [t.clone().requires_grad_() for t in (Kx, u, lam)]
    before = kernels.fused_admm_update.launches
    v, u_new = kernels.fused_admm_update(*ins, kind)
    assert kernels.fused_admm_update.launches == before + 1
    assert v.grad_fn is not None and u_new.grad_fn is not None
    wrt = ins if kind == "soft" else ins[:2]
    got = torch.autograd.grad((v * gv).sum() + (u_new * gu).sum(), wrt)
    ref_in = [t.clone().requires_grad_() for t in (Kx, u, lam)]
    rv, ru = kernels.fused_admm_update_plain(*ref_in, kind)
    ref = torch.autograd.grad((rv * gv).sum() + (ru * gu).sum(), ref_in[:2])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    w = (Kx + u)[0, 0, 0, 0]
    assert float(w) == 0.0  # a tie is in the data
    if kind == "soft":
        in64 = [t.double().requires_grad_() for t in (Kx, u, lam)]
        rv, ru = kernels.fused_admm_update_plain(*in64, kind)
        glam, = torch.autograd.grad((rv * gv.double()).sum() + (ru * gu.double()).sum(), in64[2])
        assert _rel(got[2], glam) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 3, 64, 64), (2, 3, 37, 53)])
def test_fused_cg_tail_gradient_matches_plain(cuda, shape):
    """All five inputs, against autograd of the plain version on float64
    copies: relative 1e-4 of each gradient's largest entry (the forward's
    and the backward's float32 sums, each ~1e-6 off the float64 ones,
    carried through alpha and beta)."""
    rng = np.random.RandomState(16)
    x, r, p = (_randn(rng, shape, cuda) for _ in range(3))
    Ap = p * 1.5 + 0.1 * _randn(rng, shape, cuda)
    rs = kernels.bdot_plain(r, r)
    ws = [_randn(rng, shape, cuda) for _ in range(3)] + [torch.from_numpy(
        rng.randn(shape[0]).astype(np.float32)).to(cuda)]
    ins = [t.clone().requires_grad_() for t in (x, r, p, Ap, rs)]
    before = kernels.fused_cg_tail.launches
    outs = kernels.fused_cg_tail(*ins)
    assert kernels.fused_cg_tail.launches == before + 1
    assert all(o.grad_fn is not None for o in outs)
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, ws)), ins)
    in64 = [t.double().requires_grad_() for t in (x, r, p, Ap, rs)]
    outs64 = kernels.fused_cg_tail_plain(*in64)
    ref = torch.autograd.grad(sum((o * w.double()).sum() for o, w in zip(outs64, ws)), in64)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and _rel(a, b) <= 1e-4


@pytest.mark.parametrize("prior", ["norm1", "tv"])
def test_unrolled_solve_gradient_on_cuda_matches_cpu(cuda, prior):
    """d loss / d (rhos, lams) of a 5-iteration admm solve at 1x3x32x32
    through the kernels and their backwards, against the same solve on the
    CPU (plain versions): relative 1e-3 of each gradient's largest entry
    (cuFFT against the CPU's FFT, carried through five iterations)."""
    img = imaging._synthetic_face(512, 512)[224:256, 224:256].transpose(2, 0, 1)[None]
    img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    psf = imaging.point_spread_function(5, 2)
    b = imaging.blurring(img, psf)
    grads = {}
    for device in ("cpu", "cuda"):
        x = dp.Variable()
        reg = dp.norm1(dp.grad(x)) if prior == "norm1" else dp.deep_prior(x, "tv")
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b.to(device)), reg], "admm",
                            device=device)
        rhos = torch.tensor([0.05, 0.04, 0.06, 0.05, 0.03], device=device, requires_grad=True)
        lams = torch.tensor([0.01, 0.02, 0.015, 0.01, 0.012], device=device,
                            requires_grad=True)
        kernels.reset_launches()
        out = solver.solve(x0=b.to(device), max_iter=5, rhos=rhos, lams=lams)
        loss = torch.mean((out - img.to(device)) ** 2)
        grads[device] = [g.cpu() for g in torch.autograd.grad(loss, (rhos, lams))]
        counts = kernels.launch_counts()
    assert counts["freq_divide"] == 5
    assert counts["fused_admm_update" if prior == "norm1" else "tv_denoise_chw"] == 5
    for a, c in zip(grads["cuda"], grads["cpu"]):
        assert float(c.abs().max()) > 0 and _rel(a.double(), c.double()) <= 1e-3


# --------------------------------------------------------------------------- #
# The structured CG of mosaic(conv(x)) (csrc/mosaic_pcg.cu)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(1, 3, 256, 256), (2, 3, 17, 19), (2, 3, 64, 66)])
def test_mcg_stage_kernels_match_plain(cuda, shape):
    """Each stage kernel against its plain version on the card (the
    vectorised route at 256^2 and 64 x 66, element by element at 17 x 19;
    rho per batch element), to chip_smoke.MCG_REL_TOL of the largest value;
    the stop flag equal; one launch each."""
    cs = _chip_smoke()
    rng = np.random.RandomState(4)
    B = shape[0]
    c = lambda: torch.from_numpy((rng.randn(*shape) + 1j * rng.randn(*shape))
                                 .astype(np.complex64)).to(cuda)
    f = lambda: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    pos = lambda: torch.from_numpy((0.5 + rng.rand(B)).astype(np.float32)).to(cuda)
    F, otf, x, r, p, Ap, b, z = c(), c()[:1].contiguous(), f(), f(), f(), f(), f(), f()
    mdiag, rho = (0.1 + f().abs())[:1].contiguous(), pos().reshape(-1, 1, 1, 1)
    rz, pAp, rz_new = pos(), pos(), pos()
    rmax, bmax = r.flatten(1).abs().amax(1), 2 * b.flatten(1).abs().amax(1)
    scale = 1.0 / (shape[2] * shape[3])
    zeros = lambda: torch.zeros(B, device=cuda)
    cbuf, buf = lambda: torch.empty_like(F), lambda: torch.empty_like(x)
    flag = torch.empty(1, dtype=torch.int32, device=cuda)
    pairs = {
        "mcg_otf_apply": (lambda: kernels.mcg_otf_apply(F.clone(), otf, True),
                          lambda: kernels.mcg_otf_apply_plain(F, otf, True)),
        "mcg_mask": (lambda: kernels.mcg_mask(F.clone(), scale),
                     lambda: kernels.mcg_mask_plain(F, scale)),
        "mcg_gram": (lambda: kernels.mcg_gram(F, p, rho, 2, scale, buf(), zeros()),
                     lambda: kernels.mcg_gram_plain(F, p, rho, 2, scale)),
        "mcg_step": (lambda: kernels.mcg_step(x.clone(), r.clone(), p, Ap, rz, pAp, cbuf(),
                                              zeros()),
                     lambda: kernels.mcg_step_plain(x, r, p, Ap, rz, pAp)),
        "mcg_precond": (lambda: kernels.mcg_precond(F.clone(), mdiag),
                        lambda: kernels.mcg_precond_plain(F, mdiag)),
        "mcg_real": (lambda: kernels.mcg_real(F, scale, buf()),
                     lambda: kernels.mcg_real_plain(F, scale)),
        "mcg_direction": (lambda: kernels.mcg_direction(z, p.clone(), rz_new, rz, cbuf(), rmax,
                                                        bmax, 0.6, flag),
                          lambda: kernels.mcg_direction_plain(z, p, rz_new, rz, rmax, bmax, 0.6,
                                                              False)),
        "mcg_start": (lambda: kernels.mcg_start(x, b, buf(), cbuf(), zeros(), zeros()),
                      lambda: kernels.mcg_start_plain(x, b)),
        "mcg_residual": (lambda: kernels.mcg_residual(F, b, x, rho, 1, scale, buf(), cbuf(),
                                                      zeros(), zeros()),
                         lambda: kernels.mcg_residual_plain(F, b, x, rho, 1, scale))}
    for name, (run, plain) in pairs.items():
        before = getattr(kernels, name).launches
        got, ref = run(), plain()
        got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        assert getattr(kernels, name).launches == before + 1
        if name == "mcg_direction":
            assert bool(got[2].item()) == bool(ref[2]) and bool(ref[2]) in (True, False)
            got, ref = got[:2], ref[:2]
        for g, rf in zip(got, ref):
            assert g.shape == rf.shape and g.dtype == rf.dtype, name
            err = float((g - rf).abs().max() / rf.abs().max().clamp(min=1e-30))
            assert err <= cs.MCG_REL_TOL, (name, err)


def test_mcg_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """Shapes, dtypes, devices and contiguity are checked before a pointer
    reaches a stage kernel; nothing is launched on a refusal."""
    shape = (2, 3, 8, 8)
    x = torch.zeros(shape, device=cuda)
    c = torch.zeros(shape, dtype=torch.complex64, device=cuda)
    s2, s1 = torch.zeros(2, device=cuda), torch.zeros(1, device=cuda)
    before = kernels.launch_counts()
    with pytest.raises(ValueError):  # rz of one value for two batch elements
        kernels.mcg_step(x, x.clone(), x, x, s1, s2, c, s2.clone())
    with pytest.raises(ValueError):  # a strided field
        kernels.mcg_real(c.transpose(2, 3), 1.0, x)
    with pytest.raises(ValueError):  # float64
        kernels.mcg_gram(c, x.double(), s1, 1, 1.0, x, s2)
    with pytest.raises(ValueError):  # an OTF of another shape
        kernels.mcg_otf_apply(c, c[:1, :, :4].contiguous(), False)
    with pytest.raises(TypeError):  # the flag is int32
        kernels.mcg_direction(x, x, s2, s2, c, s2, s2, 0.1, torch.zeros(1, device=cuda))
    with pytest.raises(ValueError):  # a field on the CPU
        kernels.mcg_precond(c, torch.ones(1, 3, 8, 8))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("size", [256, 2048])
def test_structured_cg_matches_pcg_on_the_card(cuda, size):
    """One x-update of the jdd_ffdnet system at 3 x size^2 by the structured
    solve and by linalg.pcg, at the schedule's first and last rho: the same
    iterations, K(x) within chip_smoke.MCG_DATA_TOL (the cell's
    data_max_err limit is 1e-3); and the structured solve's launches: each
    stage kernel as often as the iterations say, bdot 2k + 1, no divide and
    no CG tail."""
    cs = _chip_smoke()
    system = cs.mcg_system(dp, size, cuda)
    for rho in (system.rhos[0], system.rhos[-1]):
        kernels.reset_launches()
        got = cs.mcg_solves(dp, kernels, system, rho)
        counts = kernels.launch_counts()
        it_s, it_pcg = got["iterations_structured"], got["iterations_pcg"]
        assert it_s == it_pcg > 0 and got["data_max_err"] <= cs.MCG_DATA_TOL, (rho, got)
        # two warm and two timed solves of each: per structured solve of k
        # iterations, a matvec a set-up and an iteration
        k, n = it_s, 2
        assert counts == dict.fromkeys(counts, 0) | {
            "bdot": n * (2 * k + 1) + n * (2 * it_pcg + 1),
            "mcg_start": n, "mcg_residual": n, "mcg_otf_apply": n * 2 * (k + 1),
            "mcg_mask": n * (k + 1), "mcg_gram": n * k, "mcg_step": n * k,
            "mcg_precond": n * (k + 1), "mcg_real": n * (k + 1), "mcg_direction": n * (k + 1)}


def test_the_jdd_xupdate_takes_the_structured_cg_on_the_card(cuda):
    """The jdd_ffdnet problem through dp.compile on the card: every x-update
    is a structured solve (the counter), through the stage kernels, with no
    divide and no CG tail; the answer against the CPU's within 1e-4."""
    from dprox_tpu_torch.utils import profiling

    img = torch.from_numpy(np.ascontiguousarray(
        imaging._synthetic_face(512, 512)[:128, :128].transpose(2, 0, 1)[None]))
    psf = imaging.point_spread_function(15, 3)
    b = imaging.mosaicing(imaging.blurring(img, psf))
    outs = {}
    for device in ("cpu", "cuda"):
        x = dp.Variable()
        solver = dp.compile(dp.sum_squares(dp.mosaic(dp.conv(x, psf)) - dp.Placeholder("b"))
                            + dp.deep_prior(x, "tv"), "admm", device=device,
                            linear_solve_config=dp.LinearSolveConfig(max_iters=50))
        kernels.reset_launches()
        profiling.reset_counts()
        bd = b.to(device)
        outs[device] = solver.solve(x0=dp.utils.demosaic_from_mosaiced(bd), rhos=0.3,
                                    lams=0.02, max_iter=4, params={"b": bd}).cpu()
        counts, launches = profiling.counts(), kernels.launch_counts()
        assert counts["linalg.structured_pcg_solves"] == counts["linalg.solves"] == 4
        if device == "cuda":
            assert launches["mcg_step"] == counts["linalg.iterations"] > 0
            assert launches["bdot"] == 2 * counts["linalg.iterations"] + 4
            assert launches["freq_divide"] == launches["fused_cg_tail"] == 0
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 1e-4


# --------------------------------------------------------------------------- #
# The prior family and the other solvers on the card
# --------------------------------------------------------------------------- #

class _PlainTV(dp.proxfn.pnp.TVDenoiser):
    """TVDenoiser with the kernel's plain version in place of the kernel."""

    def denoise(self, x, sigma):
        B, C, H, W = x.shape
        lam = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1)
        out = kernels.tv_denoise_chw_plain(x.reshape(B * C, H, W), lam, self.iter_num)
        return out.reshape(B, C, H, W)


def test_x8_tv_both_orientations_equal_the_plain_version(cuda):
    """Under x8 a 3x384x512 input reaches the TV kernel as 384x512 and as
    512x384 planes; each call, and the x8 average, equals the plain
    version's bits. Eight launches per x8 call."""
    from dprox_tpu_torch.proxfn.pnp import Augment, TVDenoiser

    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.rand(1, 3, 384, 512).astype(np.float32)).to(cuda)
    sigma = torch.tensor([0.05], device=cuda)
    for k in range(2):
        xr = torch.rot90(x, k, dims=(-2, -1))
        got = TVDenoiser(10).denoise(xr, sigma)
        assert torch.equal(got, _PlainTV(10).denoise(xr, sigma))
    before = kernels.tv_denoise_chw.launches
    got = Augment(TVDenoiser(10)).denoise(x, sigma)
    assert kernels.tv_denoise_chw.launches == before + 8
    assert torch.equal(got, Augment(_PlainTV(10)).denoise(x, sigma))


def test_bf16_denoiser_on_cuda_matches_cpu(cuda):
    """cuDNN and oneDNN round bf16 convolutions differently: within two
    bf16 units in the last place at 1.0 (2**-6)."""
    from dprox_tpu_torch.proxfn.pnp import get_denoiser

    x = torch.from_numpy(np.random.RandomState(9).rand(1, 3, 64, 64).astype(np.float32))
    sigma = torch.tensor([0.05])
    outs = {}
    for device in ("cpu", "cuda"):
        den = get_denoiser("distilled_color_tv_bf16").to(device)
        with torch.no_grad():
            outs[device] = den.denoise(x.to(device), sigma.to(device)).cpu()
        assert outs[device].dtype == torch.float32
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 2.0 ** -6


@pytest.mark.parametrize("method", ["admm", "ladmm", "admm_vxu", "hqs", "pc", "pgd", "cadmm"])
@pytest.mark.parametrize("prior", ["nonneg", "tv"])
def test_one_iteration_of_each_solver_on_cuda_matches_cpu(cuda, method, prior):
    img = imaging._synthetic_face(512, 512)[224:288, 224:320]
    psf = imaging.point_spread_function(15, 5)
    b = imaging.blurring(dp.tensor(img, batch=True), psf)
    outs = {}
    for device in ("cpu", "cuda"):
        x = dp.Variable()
        reg = dp.nonneg(x) if prior == "nonneg" else dp.deep_prior(x, "tv")
        solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b), reg], method, device=device)
        kernels.reset_launches()
        outs[device] = solver.solve(x0=b, max_iter=1, rhos=0.05, lams=0.01).cpu()
        counts = kernels.launch_counts()
        if device == "cuda":
            assert counts["freq_divide"] == (0 if method == "pgd" else 1)
            assert counts["tv_denoise_chw"] == (prior == "tv")
            assert counts["fused_admm_update"] == (method == "admm" and prior == "nonneg")
        else:
            assert not any(counts.values())
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 1e-5


def test_equilibrate_and_norm_estimate_run_on_cuda_as_on_cpu(cuda):
    """Both default to the card. The probes come from the same CPU
    generator on either device. On a diagonal operator every probe gives
    the same magnitudes, so the scalings agree to 1e-6 relative; the
    power iteration through a convolution (FFTs on both devices) to 1e-4."""
    w = torch.from_numpy(np.random.RandomState(2).uniform(0.5, 4.0, (1, 1, 8, 8))
                         .astype(np.float32))
    psf = imaging.point_spread_function(5, 2)
    out = {}
    for device in ("cpu", "cuda"):
        kw = {} if device == "cuda" else {"device": "cpu"}
        d, e = dp.algo.stochastic_equilibrate(dp.mul_elementwise(dp.Variable(), w), (1, 1, 8, 8),
                                              iters=4, samples=3, **kw)
        assert d.device.type == e.device.type == device
        norm = dp.linop.est_CompGraph_norm(dp.conv(dp.Variable(), psf), shape=(1, 1, 16, 16),
                                           **kw)
        out[device] = d.cpu(), e.cpu(), norm
    for got, ref in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    assert abs(out["cuda"][2] - out["cpu"][2]) <= 1e-4 * out["cpu"][2]


@pytest.mark.parametrize("fshape,dshape,rshape", [
    ((1, 3, 512, 512), (1, 3, 512, 512), ()), ((2, 1, 37, 53), (1, 1, 37, 53), (2, 1, 1, 1)),
    ((1, 3, 64, 33), (1, 3, 64, 64), (1,))])  # a sliced complex diag, read by strides
def test_freq_divide_complex_divisor_matches_plain(cuda, fshape, dshape, rshape):
    """The complex-divisor entry: c10::complex's division in float32 with
    --fmad=false, against PyTorch's own on the same inputs; within 1e-6 of
    the largest output (PyTorch's CUDA build may contract to FMAs)."""
    rng = np.random.RandomState(21)
    F = torch.from_numpy((rng.randn(*fshape) + 1j * rng.randn(*fshape)).astype(np.complex64))
    diag = torch.from_numpy((rng.rand(*dshape) + 1j * rng.randn(*dshape)).astype(np.complex64))
    diag = diag[..., :fshape[-1]].to(cuda)
    rho = torch.from_numpy(np.asarray(1e-2 * (1 + rng.rand(*rshape)), np.float32)).to(cuda)
    before = kernels.freq_divide.launches, kernels.freq_divide.complex_launches
    got = kernels.freq_divide(F.to(cuda), diag, rho)
    assert (kernels.freq_divide.launches, kernels.freq_divide.complex_launches) == (
        before[0] + 1, before[1] + 1)
    ref = kernels.freq_divide_plain(F.to(cuda), diag, rho)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.dtype == torch.complex64
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_freq_divide_complex_divisor_gradient_matches_plain(cuda):
    """Against autograd of the plain version on complex128 / float64
    copies, relative 1e-5 of each gradient's largest entry."""
    rng = np.random.RandomState(22)
    shape = (2, 3, 32, 40)
    F = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    diag = (2.0 + rng.rand(1, 3, 32, 40) + 1j * rng.randn(1, 3, 32, 40)).astype(np.complex64)
    rho = (1e-2 * (1 + rng.rand(2, 1, 1, 1))).astype(np.float32)
    g = torch.from_numpy((rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64))
    ins = [torch.from_numpy(a).to(cuda).requires_grad_() for a in (F, diag, rho)]
    out = kernels.freq_divide(*ins)
    got = torch.autograd.grad(out, ins, g.to(cuda))
    ins64 = [torch.from_numpy(a).to(cuda).to(torch.complex128 if np.iscomplexobj(a)
                                             else torch.float64).requires_grad_()
             for a in (F, diag, rho)]
    ref = torch.autograd.grad(kernels.freq_divide_plain(*ins64), ins64,
                              g.to(cuda).to(torch.complex128))
    for a, b in zip(got, ref):
        assert a.shape == b.shape and _rel(a, b) <= 1e-5


def test_tv_kernel_takes_a_complex_states_real_part_made_contiguous(cuda):
    """A complex tensor's .real is a strided view: the TV wrapper refuses
    it, and the copy deep_prior makes gives the plain version's bits."""
    rng = np.random.RandomState(23)
    z = torch.from_numpy((rng.rand(1, 128, 128) + 1j * rng.rand(1, 128, 128))
                         .astype(np.complex64)).to(cuda)
    lam = torch.full((1,), 0.05, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.tv_denoise_chw(z.real, lam, 10)
    got = kernels.tv_denoise_chw(z.real.contiguous(), lam, 10)
    assert torch.equal(got, kernels.tv_denoise_chw_plain(z.real.contiguous(), lam, 10))
    x = dp.Variable()
    before = kernels.tv_denoise_chw.launches
    out = dp.deep_prior(x, "tv").to(cuda).prox(z[None], lam)
    assert kernels.tv_denoise_chw.launches == before + 1 and not out.is_complex()


def test_csmri_solve_on_cuda_matches_cpu(cuda):
    """The complex-state solve: the TV kernel once an iteration on the real
    part, no divide (the x-update is the k-space closed form) and no fused
    update; card against CPU within 1e-4 (cuFFT against the CPU FFT)."""
    from dprox_tpu_torch.contrib import csmri

    s = csmri.generate_sample(size=64, num_lines=30)
    outs = {}
    for device in ("cpu", "cuda"):
        x = dp.Variable()
        solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                            + dp.deep_prior(x, "tv", sqrt=True), "admm", device=device)
        rhos, sigmas = dp.log_descent(30, 5, 8, sigma=0.01)
        kernels.reset_launches()
        outs[device] = solver.solve(x0=s["x0"], rhos=rhos, lams=sigmas, max_iter=8,
                                    params=s["params"], real_output=True).cpu()
        if device == "cuda":
            assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0) | {
                "tv_denoise_chw": 8}
    assert outs["cuda"].dtype == torch.float32
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 1e-4


def test_sisr_solve_on_cuda_matches_cpu(cuda):
    """The fused sisr x-update with the TV prior: one TV launch an
    iteration; card against CPU within 1e-4."""
    img = dp.tensor(imaging._synthetic_face(512, 512)[:64, :64], batch=True)
    psf = imaging.point_spread_function(15, 2)
    y, x0 = imaging.downsampling(img, psf, 2)
    kernel = np.transpose(psf, (2, 0, 1))[None]
    outs = {}
    for device in ("cpu", "cuda"):
        x = dp.Variable()
        prob = dp.Problem(dp.sisr(x, dp.utils.array(y.numpy()), dp.utils.array(kernel), 2)
                          + dp.deep_prior(x, "tv"))
        rhos, sigmas = dp.log_descent(60, 20, 6)
        kernels.reset_launches()
        outs[device] = prob.solve(method="admm", device=device, x0=x0, rhos=rhos, lams=sigmas,
                                  max_iter=6).cpu()
        if device == "cuda":
            assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0) | {
                "tv_denoise_chw": 6}
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 1e-4


# --------------------------------------------------------------------------- #
# The specializations on the card
# --------------------------------------------------------------------------- #

def _nonneg_deq(device, size=32):
    img = imaging._synthetic_face(512, 512)[224:224 + size, 224:224 + size]
    img = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)[None], np.float32))
    psf = imaging.point_spread_function(5, 2)
    b = imaging.blurring(img, psf)
    x = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf) - b.to(device)), dp.nonneg(x)], "admm",
                        device=device)
    deq = dp.specialize(solver, "deq", learned_params=True, f_thres=15, b_thres=15)
    return img.to(device), b.to(device), deq


def test_deq_learned_params_gradient_on_cuda_matches_cpu(cuda):
    """The ROADMAP gate tests/test_specialization.py:68-84 on the card: the
    DEQ on the nonneg deconvolution with learned (deq_r, deq_l) gives a
    finite, non-zero gradient through the implicit backward; the forward
    launches fused_admm_update and freq_divide once an evaluation of f and
    the backward once more. Output (1e-4) and d loss / d deq_r (1e-3
    relative) against the CPU, the same stopping step."""
    res = {}
    for device in ("cpu", "cuda"):
        img, b, deq = _nonneg_deq(device)
        params = {k: v.requires_grad_() for k, v in deq.init_params().items()}
        assert params["deq_r"].device.type == device
        kernels.reset_launches()
        stats = []
        out = deq.solve(x0=b, rhos=0.1, lams=0.05, params=params, stats=stats)
        (g,) = torch.autograd.grad(torch.mean((out - img) ** 2), [params["deq_r"]])
        res[device] = out.detach().cpu(), float(g), stats[0], kernels.launch_counts()
    (out, g, stats, counts), (out_cpu, g_cpu, stats_cpu, _) = res["cuda"], res["cpu"]
    assert np.isfinite(g) and g != 0
    assert abs(g - g_cpu) <= 1e-3 * abs(g_cpu)
    assert float((out - out_cpu).abs().max()) <= 1e-4
    assert stats["forward"]["evaluations"] == stats_cpu["forward"]["evaluations"]
    n = stats["forward"]["evaluations"] + 1
    assert counts == dict.fromkeys(counts, 0) | {"freq_divide": n, "fused_admm_update": n}


def test_deq_function_on_cuda_matches_cpu(cuda):
    """deq_fixed_point on a contraction built from a kernel (the divide):
    the fixed point and the gradient of theta through the implicit
    backward, card against CPU."""
    from dprox_tpu_torch.algo.special import deq_fixed_point

    rng = np.random.RandomState(7)
    F = (rng.randn(1, 3, 16, 16) + 1j * rng.randn(1, 3, 16, 16)).astype(np.complex64)
    diag = rng.rand(1, 1, 16, 16).astype(np.float32) + 1.0
    got = {}
    for device in ("cpu", "cuda"):
        Ft, dt = torch.from_numpy(F).to(device), torch.from_numpy(diag).to(device)
        rho = torch.tensor(0.5, device=device, requires_grad=True)

        def f(theta, z):  # a contraction: |0.5 / (diag + rho)| < 1
            r = theta
            return kernels.freq_divide(Ft, dt, r).real * 0.1 + 0.5 * z / (1.0 + r)

        z = deq_fixed_point(f, rho, torch.zeros(1, 3, 16, 16, device=device), 30, 30)
        (g,) = torch.autograd.grad(z.sum(), [rho])
        got[device] = z.detach().cpu(), float(g)
    assert float((got["cuda"][0] - got["cpu"][0]).abs().max()) <= 1e-5
    assert abs(got["cuda"][1] - got["cpu"][1]) <= 1e-4 * abs(got["cpu"][1])


def test_policy_and_tuner_on_cuda_match_cpu(cuda):
    """The shipped CS-MRI policy on the card: the policy and critic live on
    the solver's device; its actions on a random observation (cuDNN against
    the CPU's convolutions, 1e-4) and a 2-step episode of 5-iteration packs
    (TV once an iteration) against the CPU."""
    import os

    from dprox_tpu_torch.contrib import csmri

    path = os.path.join(os.path.dirname(__file__), "..", "weights", "autotune_csmri.msgpack")
    s = csmri.generate_sample(size=64, num_lines=30, sigma=0.05)
    ob = torch.from_numpy(np.random.RandomState(8).rand(2, 5, 64, 64).astype(np.float32))
    x0 = np.real(s["x0"]).astype(np.float32)
    got = {}
    for device in ("cpu", "cuda"):
        x = dp.Variable()
        solver = dp.compile(dp.csmri(x, dp.Placeholder("mask", batch=False), dp.Placeholder("y"))
                            + dp.deep_prior(x, "tv", sqrt=True), "admm", device=device)
        tuner = dp.specialize(solver, "rl", action_pack=5, max_episode_step=2)
        tuner.load(path)
        assert all(p.device.type == device for p in tuner.policy.parameters())
        action = tuner.policy(ob.to(device))
        kernels.reset_launches()
        out = tuner.solve(x0, solve_params=s["params"])
        got[device] = {k: v.detach().cpu() for k, v in action.items()}, out.cpu()
        if device == "cuda":
            assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0) | {
                "tv_denoise_chw": 10}
    for k in got["cpu"][0]:
        assert float((got["cuda"][0][k] - got["cpu"][0][k]).abs().max()) <= 1e-4
    assert float((got["cuda"][1] - got["cpu"][1]).abs().max()) <= 1e-4


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    return chip_smoke


def _zoo_case(name):
    """(denoiser, input) of one zoo model at a small size."""
    from dprox_tpu_torch.proxfn.pnp import FFDNet3DDenoiser, get_denoiser

    rng = np.random.RandomState(31)
    rgb = rng.rand(1, 3, 64, 64).astype(np.float32)
    cube = rng.rand(1, 8, 32, 32).astype(np.float32)
    gray = rng.rand(1, 2, 48, 40).astype(np.float32)
    return {"tiny_drunet_color": (get_denoiser("tiny_drunet_color"), rgb),
            "tiny_drunet_color_quadrants": (get_denoiser("tiny_drunet_color"),
                                            rng.rand(1, 3, 288, 320).astype(np.float32)),
            "ensemble_tv": (get_denoiser("ensemble_tv"), rgb),
            "ircnn": (get_denoiser("ircnn"), gray), "unet": (get_denoiser("unet"), gray),
            "tiny_grunet": (get_denoiser("tiny_grunet"), cube),
            "mid_grunet_tv": (get_denoiser("mid_grunet_tv"), cube),
            "grunet_tv_2d": (get_denoiser("grunet_tv"), cube),
            "qrnn3d": (get_denoiser("qrnn3d"), cube),
            "ffdnet3d": (FFDNet3DDenoiser(in_nc=9, out_nc=8), cube)}[name]


@pytest.mark.parametrize("name", ["tiny_drunet_color", "tiny_drunet_color_quadrants",
                                  "ensemble_tv", "ircnn", "unet", "tiny_grunet",
                                  "mid_grunet_tv", "grunet_tv_2d", "qrnn3d", "ffdnet3d"])
def test_zoo_denoiser_on_cuda_matches_cpu(cuda, name):
    """Each new denoiser on the card against the same call on the CPU
    (cuDNN against the CPU's convolutions, TF32 off: 1e-4 of the largest
    output); the 2-D TV branch of grunet_tv launches the TV kernel once on
    [B * Bands, H, W]."""
    import copy
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # kinds without shipped weights warn
        den, x = _zoo_case(name)
    sigma = torch.tensor([0.05])
    with torch.no_grad():
        ref = den.denoise(torch.from_numpy(x), sigma)
        kernels.reset_launches()
        got = copy.deepcopy(den).to(cuda).denoise(torch.from_numpy(x).to(cuda), sigma.to(cuda))
    launches = kernels.launch_counts()
    assert float((got.cpu() - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    tv = {"ensemble_tv": 1, "grunet_tv_2d": 1}.get(name, 0)
    assert launches == dict.fromkeys(launches, 0) | ({"tv_denoise_chw": tv} if tv else {})


@pytest.mark.parametrize("name", ["optics_unet", "patch_nlm", "dgu"])
def test_zoo_model_on_cuda_matches_cpu(cuda, name):
    """OpticsUNet, non-local means and the DGUNet's three stages on the
    card against the CPU (1e-4 of the largest output)."""
    import copy

    from dprox_tpu_torch.models import DGUDenoiser, OpticsUNet
    from dprox_tpu_torch.proxfn.nlm import nlm_denoise

    x = torch.from_numpy(np.random.RandomState(34).rand(1, 3, 40, 48).astype(np.float32))
    torch.manual_seed(0)
    if name == "patch_nlm":
        def run(v):
            return nlm_denoise(v, torch.tensor([0.05], device=v.device))
    else:
        net = (OpticsUNet() if name == "optics_unet" else DGUDenoiser()).eval()
        if name == "dgu":  # off the zero initialization of the tail and SAM's image branch
            for w in (net.tail.weight, net.sam12.conv2.weight, net.basic.sam23.conv2.weight):
                torch.nn.init.normal_(w, std=0.05)
        nets = {"cpu": net, "cuda": copy.deepcopy(net).to(cuda)}

        def run(v):
            return nets[v.device.type](v)
    with torch.no_grad():
        ref, got = run(x), run(x.to(cuda)).cpu()
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


def test_ircnn_set_selection_reads_nothing_to_the_host(cuda):
    """IRCNN picks its weight set from sigma on the device: a CUDA graph
    captures one call (a host read would break the capture), and replaying
    it after the captured sigma changes runs the other set."""
    import warnings

    from dprox_tpu_torch.proxfn.pnp import IRCNNDenoiser

    rng = np.random.RandomState(32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        den = IRCNNDenoiser(1)
    den.stack = {k: v + 0.01 * torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
                 for k, v in den.stack.items()}  # 25 different sets
    den.to(cuda)
    x = torch.from_numpy(rng.rand(1, 1, 32, 32).astype(np.float32)).to(cuda)
    sigma = torch.tensor([0.05], device=cuda)
    with torch.no_grad():
        eager = {s: den.denoise(x, torch.tensor([s], device=cuda)) for s in (0.05, 0.5)}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            den.denoise(x, sigma)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = den.denoise(x, sigma)
        for s in (0.05, 0.5):
            sigma.fill_(s)
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager[s])
    assert not torch.equal(eager[0.05], eager[0.5])


def test_derain_training_step_on_cuda_matches_cpu(cuda):
    """A joint derain training step from the shipped weights on golden crop
    0 (7 unrolled PGD iterations, DGUNet n_feat 16, the learnable
    degradation operator): gradients on deg_op, dgu and rhos within 1e-3 of
    the largest CPU entry of each group (chip_smoke.py's gate; the CPU's own
    gradients move <= 8e-5 there when the input moves by 1e-6, where the
    random small setup of tests/test_training.py moves ~1e-3); the carry
    stays on the card."""
    cs = _chip_smoke()
    gt, rainy = cs.derain_crops()[0]
    solver, _, prior = cs.derain_pipeline(dp, "cpu")
    params = cs.derain_weights(prior, "cpu")
    kw = dict(max_iter=7, n_feat=16, scale=8)
    loss_d, g_d = cs.derain_train_grads(dp, "cuda", params, gt, rainy, **kw)
    loss_h, g_h = cs.derain_train_grads(dp, "cpu", params, gt, rainy, **kw)
    assert abs(float(loss_d) - float(loss_h)) <= 1e-5 * abs(float(loss_h))
    assert all(v <= 1e-3 for v in cs._grad_group_rel(g_d, g_h).values())
    solver, _, prior = cs.derain_pipeline(dp, "cuda")
    p = cs.derain_weights(prior, "cuda")
    with torch.no_grad():
        cs.derain_solve(solver, p, torch.from_numpy(rainy).to(cuda))
    carry = prior._carry
    assert carry is not None
    assert all(t.is_cuda for t in list(carry[0]) + list(carry[1]) + [carry[2]])


@pytest.mark.parametrize("patch,wave,sensor", [(32, 64, 15e-3), (128, 256, 80e-3),
                                               (748, 1496, 15e-3)])
def test_optic_psf_and_gradient_on_cuda_match_cpu(cuda, patch, wave, sensor):
    """contrib.optic's get_psf and d <psf, w> / d height_map_sqrt on the
    card against the CPU: the tests' optic, the golden path's (sensor at 80
    mm) and the reference's full width (2244^2 padded fields); the PSF to
    1e-4 of its largest value (float32 FFTs in two libraries), the
    gradient to 3e-3 (chip_smoke.py's GRAD_REL_TOL)."""
    from dprox_tpu_torch.contrib.optic import DOEModelConfig, build_doe_model

    cfg = DOEModelConfig(patch_size=patch, wave_resolution=(wave, wave),
                         sample_interval=2e-6 * 1496 / wave, sensor_distance=sensor)
    w = torch.from_numpy(np.random.RandomState(0).rand(1, 3, patch, patch).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        model = build_doe_model(cfg, device=dev)
        h = model.init_params()["height_map_sqrt"].requires_grad_(True)
        psf = model.get_psf({"height_map_sqrt": h})
        (psf * w.to(dev)).sum().backward()
        out[str(dev)] = (psf.detach().cpu().double(), h.grad.cpu().double())
    (pc, gc), (pd, gd) = out["cpu"], out["cuda"]
    assert float((pd - pc).abs().max() / pc.abs().max()) <= 1e-4
    assert float((gd - gc).abs().max() / gc.abs().max()) <= 3e-3


def test_optic_bilevel_step_launches_the_admm_update_and_matches_cpu(cuda):
    """tests/test_optics.py's bilevel step (nonneg, 3 admm iterations) on
    the card: one fused ADMM update and one divide an iteration; the loss
    to 1e-4 and the height map's gradient to 3e-3 of the CPU's."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from dprox_tpu_torch.contrib.optic import DOEModelConfig, build_doe_model

    gt = np.random.RandomState(0).rand(1, 3, 32, 32).astype(np.float32)
    h0 = build_doe_model(DOEModelConfig(patch_size=32, wave_resolution=(64, 64),
                                        sample_interval=2e-6 * 1496 / 64),
                         "cpu").init_params()["height_map_sqrt"]
    kernels.reset_launches()
    loss_d, grad_d = cs.bilevel_step(dp, cuda, h0, gt)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fused_admm_update"] == 3 and counts["freq_divide"] == 3
    loss_c, grad_c = cs.bilevel_step(dp, "cpu", h0, gt)
    assert abs(float(loss_d) - float(loss_c)) <= 1e-4 * float(loss_c)
    assert float((grad_d.cpu() - grad_c).abs().max() / grad_c.abs().max()) <= 3e-3


def test_codesign_step_at_batch_8_on_cuda_matches_cpu(cuda):
    """The benchmark's optic_doe step (portbench/configs/optic_doe.py) at
    its batch of 8 under one [1, 3, h, w] PSF, cut to a 64 patch on a 128
    wave grid and 3 ADMM iterations: the PSF's OTF broadcast over the batch
    in conv_doe and the divide, TV's clip codes and backward windows at 24
    planes. On the card: one divide an iteration, TV under grad and its
    backward kernel on every prior but the last, one ``ops.vjps`` a
    backward; the loss to 1e-4 and each gradient to 3e-3 of its largest
    entry (chip_smoke.py's GRAD_REL_TOL) against the CPU."""
    from dprox_tpu_torch.contrib.optic import DOEModelConfig, build_doe_model, img_psf_conv
    from dprox_tpu_torch.utils import profiling

    patch, batch, iters, sigma = 64, 8, 3, 7.65 / 255
    rng = np.random.RandomState(5)
    gt = torch.from_numpy(rng.rand(batch, 3, patch, patch).astype(np.float32))
    noise = torch.from_numpy(rng.randn(batch, 3, patch, patch).astype(np.float32))
    rhos = torch.log(torch.from_numpy(np.geomspace(0.3, 0.03, iters).astype(np.float32)))
    sigmas = torch.log(dp.log_descent(80, 30, iters)[1])
    out = {}
    for dev in ("cpu", cuda):
        model = build_doe_model(DOEModelConfig(patch_size=patch, wave_resolution=(2 * patch,) * 2,
                                               sample_interval=2e-6), device=dev)
        x = dp.Variable()
        data = dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf"), circular=True),
                              b=dp.Placeholder("y"))
        solver = dp.compile(data + dp.deep_prior(x, "res_ffdnet_color_tv"), "admm", device=dev)
        hm = model.init_params()["height_map_sqrt"].requires_grad_(True)
        lr, ls = (t.to(dev).requires_grad_(True) for t in (rhos, sigmas))
        g, n = gt.to(dev), noise.to(dev)
        kernels.reset_launches()
        before = profiling.counts().get("ops.vjps", 0)
        psf = model.get_psf({"height_map_sqrt": hm})
        y = img_psf_conv(g, psf, circular=True) + sigma * n
        xs = solver.solve(x0=y, rhos=torch.exp(lr), lams=torch.exp(ls), max_iter=iters,
                          params={"psf": psf, "y": y})
        loss = torch.mean((xs - g) ** 2)
        grads = torch.autograd.grad(loss, (hm, lr, ls))
        out[str(dev)] = (float(loss.detach()), [t.cpu().double() for t in grads])
        if dev != "cpu":
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            assert launches["freq_divide"] == iters
            assert launches["tv_denoise_chw"] == iters
            assert launches["tv_denoise_chw_vjp"] == iters - 1
            assert profiling.counts()["ops.vjps"] - before == 2 * iters - 1
    (lc, gc), (ld, gd) = out["cpu"], out["cuda"]
    assert abs(ld - lc) <= 1e-4 * abs(lc)
    for a, b in zip(gd, gc):
        assert a.shape == b.shape
        assert float((a - b).abs().max() / b.abs().max()) <= 3e-3


def test_hwc_tv_denoising_reaches_the_tv_kernel(cuda):
    """models.tv_denoising ([H, W, B]) launches the TV kernel once and gives
    the plain version's bits; the 3-D form runs the plain ops on the card."""
    from dprox_tpu_torch.models import tv_denoising, tv_denoising3d
    from dprox_tpu_torch.models.tv import tv_denoising3d_chw

    y = torch.from_numpy(np.random.RandomState(1).rand(40, 52, 3).astype(np.float32))
    before = kernels.tv_denoise_chw.launches
    got = tv_denoising(y.to(cuda), 0.1, 20)
    assert kernels.tv_denoise_chw.launches == before + 1
    ref = kernels.tv_denoise_chw_plain(y.permute(2, 0, 1).contiguous(), torch.tensor(0.1), 20)
    assert torch.equal(got.cpu(), ref.permute(1, 2, 0))
    got3 = tv_denoising3d(y.to(cuda), 0.1, 20).cpu()
    ref3 = tv_denoising3d_chw(y.permute(2, 0, 1), 0.1, 20).permute(1, 2, 0)
    assert float((got3 - ref3).abs().max()) <= 1e-5


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL world on the card (create_mesh starts it) and its
    "space" mesh; the world ends with the test."""
    import torch.distributed as dist

    from dprox_tpu_torch.parallel import create_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = create_mesh(("space",))
    yield mesh
    dist.destroy_process_group()


def test_one_rank_nccl_world_distributed_fft_and_sharded_denoise(cuda, nccl_mesh):
    """The parallel layer's collectives on NCCL: the distributed FFT pair
    (one all-to-all each way) against torch.fft.fftn at
    tests/test_parallel.py's tolerances (1e-4, round trip 1e-5) plus 1e-6
    of the value (cuFFT's 2-D transform and the row / column passes round
    the 1029 of the DC term one float32 ulp, 1.2e-4, apart), and
    sharded_denoise against the unsharded call (2e-5)."""
    import torch.distributed as dist

    from dprox_tpu_torch.parallel import sharded_denoise
    from dprox_tpu_torch.parallel.fft import make_distributed_fft2

    assert dist.get_backend() == "nccl" and nccl_mesh.device_type == "cuda"
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, 3, 64, 32).astype(np.float32)).to(cuda)
    z = x + 1j * torch.from_numpy(rng.rand(2, 3, 64, 32).astype(np.float32)).to(cuda)
    fft2, ifft2 = make_distributed_fft2(nccl_mesh, "space")
    for v in (x, z):
        F = fft2(v)
        assert F.to_local().is_cuda
        torch.testing.assert_close(F.full_tensor(), torch.fft.fftn(v, dim=(-2, -1)),
                                   atol=1e-4, rtol=1e-6)
        assert float((ifft2(F).full_tensor() - v).abs().max()) <= 1e-5
    den = dp.get_denoiser("tiny_ffdnet").to(cuda)
    noisy = torch.from_numpy(rng.rand(1, 1, 256, 256).astype(np.float32)).to(cuda)
    y = sharded_denoise(lambda blk: den.denoise(blk, 0.1), noisy, nccl_mesh, halo=16)
    assert float((y.full_tensor() - den.denoise(noisy, 0.1)).abs().max()) <= 2e-5


def test_cuda_mesh_over_a_gloo_group_raises(cuda):
    """Collectives on CUDA tensors never route through the host: a cuda
    mesh needs an NCCL process group."""
    import torch.distributed as dist

    from dprox_tpu_torch.parallel import create_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="a cuda mesh needs a nccl process group"):
            create_mesh(("space",))
    finally:
        dist.destroy_process_group()

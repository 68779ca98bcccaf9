"""The structured CG of the joint demosaic + deconvolution x-update
(dprox_tpu_torch/linalg/structured.py) against ``linalg.pcg``, on the CPU
where its stages are the wrappers' plain versions.

``least_squares.solve_cg`` takes it where the system is K^T K + n rho I with
K = mosaic(conv(x)) of a static kernel, under the implicit gradient, on
float32 [B, 3, H, W] fields; ``linalg.structured_pcg_solves`` counts its
solves. Every other tree runs ``pcg`` as it is, which the tests reach by
making the structure test see nothing (``_mosaic_conv``).

Imports neither JAX nor the JAX package.
"""
import importlib

import numpy as np
import pytest
import torch

import dprox_tpu_torch as dp
from dprox_tpu_torch.ops import kernels
from dprox_tpu_torch.utils import imaging, profiling

ss_module = importlib.import_module("dprox_tpu_torch.proxfn.sum_squares")

PSF = imaging.point_spread_function(5, 1.5)
STRUCTURED = "linalg.structured_pcg_solves"


@pytest.fixture(autouse=True)
def fresh_counts():
    profiling.reset_counts()
    yield
    profiling.reset_counts()


def _least_squares(op=None, prior=None, max_iters=40, **cfg):
    x = dp.Variable()
    op = dp.mosaic(dp.conv(x, PSF)) if op is None else op(x)
    prior = dp.deep_prior(x, "tv") if prior is None else prior(x)
    solver = dp.compile(dp.sum_squares(op - dp.Placeholder("b")) + prior, "admm",
                        device="cpu",
                        linear_solve_config=dp.LinearSolveConfig(max_iters=max_iters, **cfg))
    return solver.least_square


def _data(shape, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(*shape).astype(dtype)) for _ in range(3)]


def _solve(ls, shape, rho, with_v, generic=False, monkeypatch=None, dtype=np.float32):
    """One x-update from a warm start; returns (x, the counters it moved)."""
    b, v, warm = _data(shape, dtype=dtype)
    if generic:
        monkeypatch.setattr(ss_module, "_mosaic_conv", lambda *a: None)
    profiling.reset_counts()
    shapes = {n: shape for n in ls._var_shapes(v)}
    x = ls.solve([v], rho, v=warm if with_v else None, params={"b": b}, var_shapes=shapes,
                 warm=warm)
    if generic:
        monkeypatch.undo()
    return x, profiling.counts()


@pytest.mark.parametrize("with_v", [False, True], ids=["no_v", "v"])
@pytest.mark.parametrize("rho_kind", ["scalar", "per_batch"])
@pytest.mark.parametrize("batch", [1, 2])
def test_structured_pcg_matches_pcg(batch, rho_kind, with_v, monkeypatch):
    """Same iterations as ``pcg`` with the frequency-Jacobi preconditioner,
    x within the CG tests' 1e-4; one structured solve counted."""
    shape = (batch, 3, 16, 20)
    rho = (torch.tensor(0.2) if rho_kind == "scalar"
           else torch.tensor([0.3, 0.05][:batch], dtype=torch.float32))
    got, counts = _solve(_least_squares(), shape, rho, with_v)
    ref, ref_counts = _solve(_least_squares(), shape, rho, with_v, generic=True,
                             monkeypatch=monkeypatch)
    assert counts[STRUCTURED] == 1 and STRUCTURED not in ref_counts
    assert counts["linalg.solves"] == ref_counts["linalg.solves"] == 1
    assert counts["linalg.iterations"] == ref_counts["linalg.iterations"] > 0
    assert got.dtype == torch.float32 and got.shape == shape
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("hw", [(16, 20), (7, 9), (2, 3), (1, 1)])
def test_parity_mask_is_the_bayer_mask(hw):
    """The kernels' mask from (c, h, w) parity is bayer_mask bit for bit."""
    assert torch.equal(kernels.bayer_parity_mask(3, *hw),
                       torch.from_numpy(imaging.bayer_mask(hw)))


def _conv_doe(x):
    psf = np.transpose(PSF, (2, 0, 1)) * np.ones((3, 1, 1), np.float32)  # [C, h, w]
    return dp.mosaic(dp.conv_doe(x, psf.astype(np.float32)))


@pytest.mark.parametrize("case", ["conv_doe", "stacked", "float64", "unrolled", "cg_pallas"])
def test_other_trees_keep_pcg(case):
    """The counter stays 0 where the structure or the path differs: a
    learned-PSF convolution, two quadratic terms stacked, float64 fields,
    ``use_analytic_grad=False`` (unrolled CG), an unpreconditioned solver."""
    kwargs, dtype, op, prior = {}, np.float32, None, None
    if case == "conv_doe":
        op = _conv_doe
    elif case == "stacked":
        prior = lambda x: dp.deep_prior(x, "tv") + dp.sum_squares(dp.grad(x, 0))  # noqa: E731
    elif case == "float64":
        dtype = np.float64
    elif case == "unrolled":
        kwargs = dict(use_analytic_grad=False)
    else:
        kwargs = dict(solver_type="cg_pallas")
    ls = _least_squares(op, prior, **kwargs)
    x, counts = _solve(ls, (1, 3, 16, 16), torch.tensor(0.2), False, dtype=dtype)
    assert counts.get(STRUCTURED, 0) == 0 and counts["linalg.solves"] >= 1
    assert bool(torch.isfinite(x).all())


def test_the_frequency_xupdate_counts_no_structured_solve():
    """The deconvolution (the deconv_ffdnet cells' operator, conv alone) divides
    in frequency and never reaches CG: no solve of either kind is counted."""
    ls = _least_squares(op=lambda x: dp.conv(x, PSF))
    assert ls.freq_diagonalizable
    x, counts = _solve(ls, (1, 3, 16, 16), torch.tensor(0.2), False)
    assert counts.get(STRUCTURED, 0) == 0 and counts.get("linalg.solves", 0) == 0
    assert bool(torch.isfinite(x).all())


def test_admm_counts_a_structured_solve_every_xupdate():
    """The joint demosaic + deconvolution solve: every x-update of the ADMM
    loop is one structured solve."""
    img = torch.from_numpy(np.ascontiguousarray(
        imaging._synthetic_face(512, 512)[200:232, 200:232].transpose(2, 0, 1)[None]))
    b = imaging.mosaicing(imaging.blurring(img, PSF))
    x = dp.Variable()
    solver = dp.compile(dp.sum_squares(dp.mosaic(dp.conv(x, PSF)) - dp.Placeholder("b"))
                        + dp.deep_prior(x, "tv"), "admm", device="cpu",
                        linear_solve_config=dp.LinearSolveConfig(max_iters=50))
    out = solver.solve(x0=dp.utils.demosaic_from_mosaiced(b), rhos=0.05, lams=0.02,
                       max_iter=4, params={"b": b})
    counts = profiling.counts()
    assert counts[STRUCTURED] == counts["linalg.solves"] == 4
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("rho_kind", ["scalar", "per_batch"])
def test_implicit_gradients_match_the_generic_path(rho_kind, monkeypatch):
    """d loss / d (b, rho) through ``_ImplicitSolve``: its backward's
    transposed solve is structured too (two counted solves), and the
    gradients equal the generic path's."""
    shape = (2, 3, 16, 16)
    b0, v0, w = _data(shape, seed=3)
    rho0 = [0.2] if rho_kind == "scalar" else [0.3, 0.08]
    grads = {}
    for generic in (False, True):
        if generic:
            monkeypatch.setattr(ss_module, "_mosaic_conv", lambda *a: None)
        ls = _least_squares(max_iters=100, rtol=1e-6)
        b = b0.clone().requires_grad_()
        rho = torch.tensor(rho0, requires_grad=True)
        profiling.reset_counts()
        x = ls.solve([v0], rho, params={"b": b}, var_shapes={n: shape for n in ls._var_shapes(v0)})
        gb, grho = torch.autograd.grad((x * w).sum(), (b, rho))
        grads[generic] = gb, grho, profiling.counts().get(STRUCTURED, 0)
        monkeypatch.undo()
    (gb, grho, n), (gb_ref, grho_ref, n_ref) = grads[False], grads[True]
    assert (n, n_ref) == (2, 0)
    assert float((gb - gb_ref).abs().max()) <= 1e-4 * float(gb_ref.abs().max())
    assert float((grho - grho_ref).abs().max()) <= 1e-4 * float(grho_ref.abs().max())


def test_plain_stages_compose_to_the_matvec():
    """The plain stages of one matvec (gram_spectrum, then mcg_gram) equal
    least_squares.solve_cg's K^T K p + rho p on the same p."""
    from dprox_tpu_torch.linalg import structured

    shape = (2, 3, 16, 16)
    p, b, _ = _data(shape, seed=5)
    x = dp.Variable()
    fn = dp.sum_squares(dp.mosaic(dp.conv(x, PSF)) - dp.Placeholder("b"))
    rho = torch.tensor([0.3, 0.05]).reshape(2, 1, 1, 1)
    params = {"b": b}
    ref = (0.0 + fn.dag_adjoint(fn.dag_forward(p, params), params)) + rho * p
    otf = dp.conv(x, PSF)._otf(shape).contiguous()
    scale = 1.0 / (16 * 16)
    got = kernels.mcg_gram(structured.gram_spectrum(otf, p.to(torch.complex64), scale), p, rho,
                           1, scale, None, None)
    assert float((got - ref).abs().max()) <= 1e-6

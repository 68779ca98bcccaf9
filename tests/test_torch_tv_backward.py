"""The TV backward's plain version against JAX and autograd.

``kernels.tv_denoise_chw_vjp_plain`` is the explicit adjoint recursion
that the backward kernel (csrc/tv_denoise.cu, run on the card by
tests/test_torch_cuda.py and chip_smoke.py) follows op for op. Here it is
held against ``jax.vjp`` of the JAX package's ``tv_denoising_chw`` (one
lam, as the JAX function takes it) and against ``torch.autograd.grad``
through the port's plain TV (one lam or one per plane), on the same numpy
inputs: d y0 and d lam within 1e-6 of the gradient's largest entry, over
both (float32 in two orders of summation; d lam adds 2 (iterations - 1)
terms a cell, each of d y0's size, so its rounding follows their size and
not its own value, which cancels: relative to itself it moves by up to
3e-5 between the two backends). The tie case is lam = 0 on a piecewise-constant
image, where max(p, -t) and min(., t) both tie wherever the image is flat
(random inputs give no exact ties).

The last tests stand in, on the CPU, for the backward kernel's window: the
same recursion on a window alone, zeros beyond it, is exact on the cells
iterations - 1 in from its edges, and a halo one cell short is not.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dprox_tpu.models.tv import tv_denoising_chw as jax_tv
from dprox_tpu_torch.ops import kernels

RTOL = 1e-6
MAX_IT = kernels.tv_max_iterations()

# (shape, iterations, kind): planes 1 and 3, H or W = 2, 1 / 5 / 10 / the
# kernel's largest count, and the tie case
CASES = [((1, 12, 10), 1, "rand"), ((3, 12, 10), 5, "rand"), ((1, 2, 9), 10, "rand"),
         ((3, 9, 2), 10, "rand"), ((3, 16, 13), MAX_IT, "rand"), ((1, 7, 31), 10, "rand"),
         ((3, 20, 20), 10, "tie"), ((1, 2, 2), 5, "tie")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the test workers share the
    CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, kind, per_plane, seed=0):
    """(y0, lam, g) as float32 numpy: a random image, or for "tie" a
    piecewise-constant one with lam = 0; lam once or once per plane."""
    rng = np.random.RandomState(seed)
    n = shape[0] if per_plane else 1
    if kind == "tie":
        blocks = rng.randint(0, 3, (shape[0], -(-shape[1] // 4), -(-shape[2] // 4)))
        y = np.kron(blocks, np.ones((1, 4, 4)))[:, :shape[1], :shape[2]]
        lam = np.zeros(n)
    else:
        y = rng.rand(*shape)
        lam = 0.02 + 0.1 * rng.rand(n)
    g = rng.randn(*shape)
    return y.astype(np.float32), lam.astype(np.float32), g.astype(np.float32)


def _close(got, ref):
    """max |got - ref| over (d y0, d lam) <= RTOL x the largest |ref| entry
    of either; returns that error over the largest entry."""
    got = [np.asarray(a, np.float64) for a in got]
    ref = [np.asarray(a, np.float64) for a in ref]
    assert [a.shape for a in got] == [a.shape for a in ref]
    scale = max(max(float(np.abs(a).max()) for a in ref), 1e-30)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref)) / scale
    assert err <= RTOL, err
    return err


@pytest.mark.parametrize("shape,iterations,kind", CASES)
def test_vjp_plain_matches_jax_vjp(shape, iterations, kind):
    y, lam, g = _inputs(shape, kind, per_plane=False)
    _, pullback = jax.vjp(lambda a, l: jax_tv(a, l, iterations), jnp.asarray(y),
                          jnp.asarray(lam[0]))
    ref_dy, ref_dlam = pullback(jnp.asarray(g))
    dy, dlam = kernels.tv_denoise_chw_vjp_plain(torch.from_numpy(y), torch.tensor(lam[0]),
                                                iterations, torch.from_numpy(g))
    assert dlam.shape == ()
    _close((dy.numpy(), dlam.numpy()), (ref_dy, ref_dlam))
    if kind == "tie" and iterations > 1:
        assert float(ref_dlam) != 0.0  # the ties reach d lam


@pytest.mark.parametrize("per_plane", [False, True])
@pytest.mark.parametrize("shape,iterations,kind", CASES)
def test_vjp_plain_matches_autograd(shape, iterations, kind, per_plane):
    """Against torch.autograd.grad through the plain TV; lam of shape [1]
    or [planes] (one value sums over every plane). On CPU tensors the
    wrapper ``tv_denoise_chw_vjp`` is the plain version."""
    y, lam, g = (torch.from_numpy(a) for a in _inputs(shape, kind, per_plane, seed=1))
    yr, lr = y.clone().requires_grad_(), lam.clone().requires_grad_()
    ref = torch.autograd.grad(kernels.tv_denoise_chw_plain(yr, lr, iterations), (yr, lr), g,
                              allow_unused=True)
    ref = [torch.zeros_like(t) if r is None else r for t, r in zip((y, lam), ref)]
    got = kernels.tv_denoise_chw_vjp_plain(y, lam, iterations, g)
    wrapped = kernels.tv_denoise_chw_vjp(y, lam, iterations, g)
    _close([a.numpy() for a in got], [b.numpy() for b in ref])
    for a, b, w in zip(got, ref, wrapped):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, w)


def test_vjp_plain_in_float64_on_float32_branches():
    """A float64 cotangent runs the recursion in float64 on the float32
    forward's clip branches: within float32 rounding of the float32 run,
    and the reference the card's checks hold the kernel to."""
    y, lam, g = (torch.from_numpy(a) for a in _inputs((3, 24, 17), "rand", True, seed=2))
    dy32, dlam32 = kernels.tv_denoise_chw_vjp_plain(y, lam, 10, g)
    dy64, dlam64 = kernels.tv_denoise_chw_vjp_plain(y, lam, 10, g.double())
    assert dy64.dtype == dlam64.dtype == torch.float64
    _close((dy32.numpy(), dlam32.numpy()), (dy64.numpy(), dlam64.numpy()))


# --------------------------------------------------------------------------- #
# The backward kernel's halo: every adjoint step of a window at once
# --------------------------------------------------------------------------- #

HALO_SHAPE = (1, 40, 48)
HALO_LAM = 0.5  # few duals clip, so an error at a window's edge travels inward


def _pre_clip(y0, lam, iterations):
    """The forward's pre-clip duals (ph, pv) of each live update, as
    ``tv_denoise_chw_vjp_plain`` computes them, and t = lam / 2."""
    t = torch.as_tensor(lam, dtype=y0.dtype) / 2.0
    zh, zv = torch.zeros_like(y0[..., 1:]), torch.zeros_like(y0[..., 1:, :])
    pre = []
    for _ in range(iterations - 1):
        x0 = ((y0 - kernels._dht_w(zh)) + (y0 - kernels._dvt_w(zv))) / 2.0
        ph, pv = zh + 0.2 * kernels._dh_w(x0), zv + 0.2 * kernels._dv_w(x0)
        pre.append((ph, pv))
        zh, zv = kernels._clip(ph, t), kernels._clip(pv, t)
    return pre, t


def _cut(x, r0, c0, h, w):
    """x[..., r0:r0 + h, c0:c0 + w] of a [..., H', W'] array, zero where the
    window leaves it (r0, c0 may be negative)."""
    out = x.new_zeros(x.shape[:-2] + (h, w))
    rs, cs = max(r0, 0), max(c0, 0)
    re, ce = min(r0 + h, x.shape[-2]), min(c0 + w, x.shape[-1])
    if rs < re and cs < ce:
        out[..., rs - r0:re - r0, cs - c0:ce - c0] = x[..., rs:re, cs:ce]
    return out


def _window_adjoint(pre, t, g, r0, c0, h, w):
    """The adjoint recursion of ``tv_denoise_chw_vjp_plain`` on the window of
    h x w cells at (r0, c0) alone, as the backward kernel runs it: the full
    forward's pre-clip duals cut to the window, g cut to it, and zeros for a
    and q beyond the window's edges (and for the duals the image does not
    have). Returns the window's d y0."""
    H, W = g.shape[-2:]
    ones = torch.ones(g.shape[:-2] + (H, W), dtype=torch.bool)
    mh, mv = _cut(ones[..., :, :-1], r0, c0, h, w), _cut(ones[..., :-1, :], r0, c0, h, w)
    a = dy = _cut(g, r0, c0, h, w)
    qh, qv = torch.zeros_like(a), torch.zeros_like(a)
    zcol, zrow = a.new_zeros(a.shape[:-1] + (1,)), a.new_zeros(a.shape[:-2] + (1, w))
    for ph, pv in reversed(pre):
        a_right = torch.cat([a[..., 1:], zcol], -1)
        a_down = torch.cat([a[..., 1:, :], zrow], -2)
        nh, _ = kernels._tv_clip_vjp(_cut(ph, r0, c0, h, w), t, qh - (a_right - a) / 2.0)
        nv, _ = kernels._tv_clip_vjp(_cut(pv, r0, c0, h, w), t, qv - (a_down - a) / 2.0)
        qh, qv = torch.where(mh, nh, 0.0), torch.where(mv, nv, 0.0)
        sh, sv = 0.2 * qh, 0.2 * qv
        a = ((torch.cat([zcol, sh[..., :-1]], -1) - sh)
             + (torch.cat([zrow, sv[..., :-1, :]], -2) - sv))
        dy = dy + a
    return dy


def _halo_problem(iterations, seed=31):
    rng = np.random.RandomState(seed)
    y = torch.from_numpy(rng.rand(*HALO_SHAPE).astype(np.float32))
    g = torch.from_numpy(rng.randn(*HALO_SHAPE).astype(np.float32))
    lam = torch.tensor(HALO_LAM)
    dy, _ = kernels.tv_denoise_chw_vjp_plain(y, lam, iterations, g)
    pre, t = _pre_clip(y, lam, iterations)
    return pre, t, g, dy


# where a window's output rectangle (OUT x OUT cells) starts: at each image
# corner (so that each image edge is touched twice) and inside
OUT = 9
PLACES = {"top_left": (0, 0), "top_right": (0, HALO_SHAPE[2] - OUT),
          "bottom_left": (HALO_SHAPE[1] - OUT, 0),
          "bottom_right": (HALO_SHAPE[1] - OUT, HALO_SHAPE[2] - OUT), "inside": (15, 20)}


def _interior_equal(iterations, place, halo):
    """Runs the window whose output rectangle starts at PLACES[place] with
    a halo of ``halo`` cells; returns (window d y0 on the rectangle, the
    full plain adjoint's d y0 there)."""
    pre, t, g, dy = _halo_problem(iterations)
    i0, j0 = PLACES[place]
    win = _window_adjoint(pre, t, g, i0 - halo, j0 - halo, OUT + 2 * halo, OUT + 2 * halo)
    return win[..., halo:halo + OUT, halo:halo + OUT], dy[..., i0:i0 + OUT, j0:j0 + OUT]


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("iterations", [2, 5, 10])
def test_window_with_halo_of_iterations_minus_one_is_exact(iterations, place):
    """A window with a halo of iterations - 1 cells on every side, zeros for
    a and q beyond it, gives the full plain adjoint's d y0 on its output
    rectangle: equal values, every cell (torch.equal), at each image edge
    and inside."""
    got, ref = _interior_equal(iterations, place, iterations - 1)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("iterations", [5, 10])
def test_window_with_halo_one_cell_short_differs(iterations):
    """The same window inside the image with a halo one cell short: some
    output cell differs from the full adjoint's (so the test above can see a
    halo that is too small)."""
    got, ref = _interior_equal(iterations, "inside", iterations - 2)
    assert not torch.equal(got, ref)
    assert torch.equal(got[..., 1:-1, 1:-1], ref[..., 1:-1, 1:-1])  # only the edge ring


def test_backward_windows_take_every_iteration_count():
    """The tallest backward window keeps an output row at the kernel's
    largest iteration count (a halo of iterations - 1 cells)."""
    rows = max(warps * rpt for warps, rpt in kernels.TV_VJP_WINDOWS)
    assert rows - 2 * (kernels.tv_max_iterations() - 1) >= 1

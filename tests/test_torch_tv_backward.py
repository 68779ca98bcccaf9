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

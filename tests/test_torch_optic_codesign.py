"""The DOE co-design training step in the port against the benchmark's plain
reference (portbench/reference/optic.py), on the CPU.

One step: the PSF of the Fresnel-lens height map (the 15 mm optic cut to
a 32 patch on a 64 wave grid), the measurement img_psf_conv(gt, psf) +
7.65 / 255 n of a batch of 2, 3 ADMM iterations of
sum_squares(conv_doe(x, psf), y) + deep_prior(x, "res_ffdnet_color_tv")
with seeded random weights in the 96-wide, 10-deep FFDNet, the MSE and
its gradients with respect to the height map and the log schedules.
Tolerances: the loss 1e-5 relative, each gradient 1e-4 of its largest
entry (float32 FFTs and sums in other orders). Also the spans
``dprox.optic`` and ``dprox.vjp`` and the counter ``ops.vjps``
(utils/profiling.py), with the kernels' autograd Functions run on their
plain versions, as tests/test_torch_grad.py runs them.

Imports neither JAX nor the JAX package.
"""
import os
import sys

import numpy as np
import pytest
import torch

import dprox_tpu_torch as dp
from dprox_tpu_torch.contrib.optic import DOEModelConfig, build_doe_model, img_psf_conv
from dprox_tpu_torch.ops import kernels
from dprox_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from portbench.reference import optic as ref  # noqa: E402

PATCH, GRID, BATCH, ITERS = 32, 64, 2, 3
DX, DISTANCE = 2e-6 * 1496 / GRID, 15e-3
WAVES, IDCS = (460e-9, 550e-9, 640e-9), (1.4648, 1.4599, 1.4568)
SIGMA = 7.65 / 255
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset_spans()
    profiling.reset_counts()
    yield
    profiling.reset_spans()


def ffdnet_weights(seed=0):
    """Seeded He-normal weights of the color FFDNet, 96 wide and 10 deep
    (12 + 1 inputs after the pixel unshuffle and the noise map, 12 out)."""
    gen = torch.Generator().manual_seed(seed)
    chans = [13] + [96] * 9 + [12]
    out = {}
    for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
        scale = 0.5 * (2.0 / (9 * ci)) ** 0.5
        out[f"convs.{i}.weight"] = scale * torch.randn(co, ci, 3, 3, generator=gen)
        out[f"convs.{i}.bias"] = 0.01 * torch.randn(co, generator=gen)
    return out


@pytest.fixture(scope="module")
def setup():
    weights = ffdnet_weights()
    model = build_doe_model(DOEModelConfig(patch_size=PATCH, wave_resolution=(GRID, GRID),
                                           sample_interval=DX, sensor_distance=DISTANCE),
                            device="cpu")
    x = dp.Variable()
    data = dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf"), circular=True),
                          b=dp.Placeholder("y"))
    solver = dp.compile(data + dp.deep_prior(x, "res_ffdnet_color_tv"), "admm", device="cpu")
    solver.psi_fns[0].denoiser.deep.module.load_state_dict(weights)
    gen = torch.Generator().manual_seed(1)
    gt = torch.rand(BATCH, 3, PATCH, PATCH, generator=gen)
    noise = torch.randn(BATCH, 3, PATCH, PATCH, generator=gen)
    rhos = np.geomspace(0.3, 0.03, ITERS).astype(np.float32)
    _, sigmas = dp.log_descent(80, 30, ITERS)
    schedule = (torch.log(torch.from_numpy(rhos)), torch.log(sigmas))
    codesign = ref.CoDesign(ref.Optic(PATCH, GRID, DX, DISTANCE, WAVES, IDCS, "cpu"), weights,
                            10, True, 0.5, 10, SIGMA)
    hm0 = model.init_params()["height_map_sqrt"]
    return model, solver, codesign, hm0, schedule, gt, noise


def port_step(model, solver, hm0, schedule, gt, noise):
    """The benchmark's timed call (portbench/configs/optic_doe.py), with
    the loss and every gradient returned."""
    hm = hm0.detach().requires_grad_(True)
    lr, ls = (t.detach().requires_grad_(True) for t in schedule)
    psf = model.get_psf({"height_map_sqrt": hm})
    y = img_psf_conv(gt, psf, circular=True) + SIGMA * noise
    out = solver.solve(x0=y, rhos=torch.exp(lr), lams=torch.exp(ls), max_iter=ITERS,
                       params={"psf": psf, "y": y})
    loss = torch.mean((out - gt) ** 2)
    return loss.detach(), torch.autograd.grad(loss, (hm, lr, ls))


def assert_close(got, want):
    (loss, grads), (ref_loss, ref_grads) = got, want
    assert abs(float(loss) - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    for name, g, r in zip(("height_map_sqrt", "log_rhos", "log_sigmas"), grads, ref_grads):
        assert g.shape == r.shape, name
        scale = float(r.abs().max())
        assert scale > 0, name
        assert float((g - r).abs().max()) <= GRAD_RTOL * scale, name


@pytest.fixture(scope="module")
def reference(setup):
    model, solver, codesign, hm0, (lr, ls), gt, noise = setup
    return codesign.step(hm0, lr, ls, gt, noise)


def test_the_ports_step_matches_the_reference(setup, reference):
    model, solver, codesign, hm0, schedule, gt, noise = setup
    assert_close(port_step(model, solver, hm0, schedule, gt, noise), reference)


def test_the_reference_per_image_sum_is_its_batch_gradient(setup, reference):
    """The loss is a mean over the batch and the PSF is shared: the sum of
    the per-image gradients is the whole batch's."""
    _, _, codesign, hm0, (lr, ls), gt, noise = setup
    assert_close(codesign.step(hm0, lr, ls, gt, noise, per_image=False), reference)


@pytest.fixture
def functions_on_the_cpu(monkeypatch):
    """The wrappers take their autograd Functions (the card's route) with
    each launch replaced by its plain version: TV's forward keeps y0 where
    the kernel keeps its clip codes, and its backward is the plain
    adjoint from it."""
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_tv_launch", lambda y, l, it, codes=False: (
        (kernels.tv_denoise_chw_plain(y, l, it), y) if codes
        else kernels.tv_denoise_chw_plain(y, l, it)))
    monkeypatch.setattr(kernels, "_tv_vjp_launch", kernels.tv_denoise_chw_vjp_plain)
    monkeypatch.setattr(kernels, "_freq_divide_launch", kernels.freq_divide_plain)


# a solve of n iterations: n divides, each on the gradient's path, and n
# priors, of which the last feeds nothing the loss reads (TV's backward
# n - 1 times)
VJPS = ITERS + (ITERS - 1)


def test_spans_and_the_vjp_counter_under_a_profiler(setup, reference, functions_on_the_cpu):
    model, solver, codesign, hm0, schedule, gt, noise = setup
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = port_step(model, solver, hm0, schedule, gt, noise)
    assert_close(got, reference)
    names = [r["name"] for r in profiling.span_records()]
    assert names.count("dprox.optic") == 1  # one get_psf
    assert names.count("dprox.vjp") == VJPS
    assert profiling.counts()["ops.vjps"] == VJPS
    vjps = [r for r in profiling.span_records() if r["name"] == "dprox.vjp"]
    assert all(r["counts"] == {} for r in vjps)  # the counter moves before the span opens
    events = [e.name for e in prof.events()]
    assert events.count("dprox.optic") == 1 and events.count("dprox.vjp") == VJPS


def test_spans_are_off_without_a_profiler(setup, functions_on_the_cpu):
    """No profiler: no span opens or records, the counter counts."""
    model, solver, codesign, hm0, schedule, gt, noise = setup
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("dprox.optic") is profiling.span("dprox.vjp")
    port_step(model, solver, hm0, schedule, gt, noise)
    assert profiling.span_records() == []
    assert profiling.counts()["ops.vjps"] == VJPS


def test_every_psf_simulation_is_one_optic_span(setup):
    model, _, _, hm0, *_ = setup
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            model.get_psf({"height_map_sqrt": hm0})
    records = profiling.span_records()
    assert [r["name"] for r in records] == ["dprox.optic"] * 3
    assert all(r["depth"] == 0 and r["host_ms"] > 0 for r in records)

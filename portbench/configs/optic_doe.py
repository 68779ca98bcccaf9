"""optic_doe: one training step of the end-to-end DOE co-design a call.

Delta-Prox's SIGGRAPH 2023 optics co-design (e2e_optics_dprox.py's
``step_fn``) in the port: the PSF of the Fresnel-lens height map through
the full-width optic (3 wavelengths on a 1496^2 grid padded to 2244^2,
cuFFT), the measurement ``img_psf_conv(gt, psf) + 7.65 / 255 n`` of a batch
of 748^2 patches, 10 ADMM iterations of sum_squares(conv_doe(x, psf), y) +
deep_prior(x, "res_ffdnet_color_tv") (the frequency x-update with the
``freq_divide`` kernel; 0.5 color FFDNet + 0.5 TV through the
``tv_denoise_chw`` kernel), the MSE against the batch, and
``torch.autograd.grad`` of it with respect to the height map and the log
schedules: cuDNN's backward-data, TV's backward kernel, the divide's VJP
and the optic's FFTs. The call returns the height map's gradient, which
every stage reaches. Every call starts from the same height map and
schedule (no optimiser step), so its answer depends only on the batch.
The sizes are in optic_doe.json; the plain reference is
``reference/optic.py``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench import counts, workload
from portbench.case import Case
from portbench.reference import optic

SPEC = json.loads(Path(__file__).with_suffix(".json").read_text())

# operations per element of the parts counted from the expressions the
# step evaluates (a complex multiply counts 6, a complex by real divide 2)
DIVIDE_VJP_OPS_PER_ELEMENT = 12  # g / D, -(g conj(out)).real / D, the sums to rho and diag
XUPDATE_OPS_PER_ELEMENT = 3      # rho z, the numerator's complex add, Re of the inverse FFT
OPTIC_FIELD_OPS_PER_POINT = 10   # phase_scale h^2, cos and sin, the aperture, abs^2
OTF_APPLY_OPS_PER_ELEMENT = 6    # a spectrum times the OTF (or the propagator's H)


def grid(traffic: dict) -> int:
    """The wave grid's side: the source's 2 samples a pixel of the patch."""
    return SPEC["wave_resolution"] * traffic["size"] // SPEC["patch_size"]


def schedule(traffic: dict, device):
    """(log rhos, log sigmas) of the hand schedule, float32 on ``device``:
    rho = geomspace(0.3, 0.03), sigma (squared, as the port's
    ``log_descent`` gives it) from log_descent(80, 30)."""
    sched, n = traffic["schedule"], traffic["iterations"]
    if sched["kind"] != "hand":
        raise ValueError(f"unknown schedule kind {sched['kind']!r}")
    rhos = np.geomspace(*sched["rho"]["geomspace"], n).astype(np.float32)
    _, sigmas = workload.log_descent(*sched["sigma"]["log_descent"], n)
    return (torch.log(torch.from_numpy(rhos)).to(device),
            torch.log(torch.from_numpy(sigmas)).to(device))


def build(traffic: dict, seed: int, device) -> Case:
    import dprox_tpu_torch as dp
    from dprox_tpu_torch.contrib.optic import DOEModelConfig, build_doe_model, img_psf_conv

    size, batch, iters, pool = (traffic[k] for k in ("size", "batch", "iterations", "pool"))
    side, dx, distance = grid(traffic), SPEC["sample_interval"], SPEC["sensor_distance"]
    waves, idcs = tuple(SPEC["wave_lengths"]), tuple(SPEC["refractive_idcs"])
    model = build_doe_model(DOEModelConfig(patch_size=size, wave_resolution=(side, side),
                                           sample_interval=dx, sensor_distance=distance,
                                           wave_lengths=waves, refractive_idcs=idcs),
                            device=device)
    images = workload.image_pool(seed, pool * batch, size, device).reshape(
        pool, batch, 3, size, size)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([seed, 3]).integers(2 ** 63 - 1)))
    noise = torch.randn(images.shape, generator=gen, device=device)
    log_rhos, log_sigmas = schedule(traffic, device)
    weights = {k: v.to(device) for k, v in workload.ffdnet_weights(SPEC["weights"]).items()}

    x = dp.Variable()
    data = dp.sum_squares(dp.conv_doe(x, dp.Placeholder("psf"), circular=True),
                          b=dp.Placeholder("y"))
    solver = dp.compile(data + dp.deep_prior(x, SPEC["prior"]), "admm", device=device)
    held = solver.psi_fns[0].denoiser.deep.module.state_dict()
    if held.keys() != weights.keys() or not all(torch.equal(held[k], weights[k]) for k in held):
        raise RuntimeError(f"the port's {SPEC['prior']} prior does not hold the weights of "
                           f"{SPEC['weights']} bit for bit")
    # the Fresnel lens of DOEModelConfig(), the point both sides differentiate at
    start = model.init_params()["height_map_sqrt"]
    sigma = SPEC["noise_sigma"]

    def call(j: int) -> torch.Tensor:
        hm = start.detach().requires_grad_(True)
        lr, ls = (t.detach().requires_grad_(True) for t in (log_rhos, log_sigmas))
        psf = model.get_psf({"height_map_sqrt": hm})
        y = img_psf_conv(images[j], psf, circular=True) + sigma * noise[j]
        out = solver.solve(x0=y, rhos=torch.exp(lr), lams=torch.exp(ls), max_iter=iters,
                           params={"psf": psf, "y": y})
        loss = torch.mean((out - images[j]) ** 2)
        # allow_unused: a faulty solver that never reads the schedule
        # (readings.py's fault) still yields the height map's gradient
        return torch.autograd.grad(loss, (hm, lr, ls), allow_unused=True)[0]

    codesign = optic.CoDesign(
        optic.Optic(size, side, dx, distance, waves, idcs, device), weights,
        SPEC["num_layers"], SPEC["residual"], SPEC["deep_weight"], SPEC["tv_iterations"], sigma)

    def reference(j: int, control: bool = False) -> torch.Tensor:
        """The height map's gradient at the port's starting height map, in
        float32 with TF32 off, or with the network in bfloat16."""
        return codesign.step(start, log_rhos, log_sigmas, images[j], noise[j], control)[1][0]

    return Case(call=call, reference=reference, images_per_call=traffic["images_per_call"],
                iterations=iters, counts=work(traffic))


def tv_bytes(planes: int, h: int, w: int, iterations: int) -> float:
    """TV under grad, either pass: y0 (the cotangent) read, the output (d
    y0) written, and the clip codes, a byte a cell of each of the
    ``iterations - 1`` live dual updates with rows padded to 4 bytes,
    written by the forward and read by the backward."""
    return counts.tv_bytes(planes, h, w) + (iterations - 1) * planes * h * (-(-w // 4) * 4)


def work(traffic: dict) -> dict:
    """Operations per call and each port kernel launch's bound, from
    shapes. The forward runs every iteration's prior and x-update; the
    backward reaches every x-update, and every prior but the last, whose
    output no later iteration reads."""
    s, batch, iters = traffic["size"], traffic["batch"], traffic["iterations"]
    planes, tv_it, side = 3 * batch, SPEC["tv_iterations"], grid(traffic)
    elems = planes * s * s
    wave = 3 * side * side                         # the optic's field
    padded = side + 2 * (side // 4)                # its propagation grid
    fft_image = counts.fft2_flops(planes, s, s)    # a batch of images
    fft_psf = counts.fft2_flops(3, s, s)           # the PSF's OTF
    fft_wave = counts.fft2_flops(3, padded, padded)
    conv = batch * counts.ffdnet_flops(SPEC["in_nc"], SPEC["nc"], SPEC["num_layers"], s, s)
    priors_back = iters - 1
    per_call = {
        # FFDNet's forward every iteration, its backward-data where the
        # gradient reaches (the network's weights are frozen: no wgrad)
        "ffdnet_conv": (iters + priors_back) * conv,
        "tv": (iters + priors_back) * counts.tv_ops(planes, s, s, tv_it),
        # forward: the optic's 2 at 2244^2; the PSF's OTF 3 times (the
        # measurement's, the x-update's H and |H|^2); F(gt) and the inverse
        # of the measurement, F(y), 2 an x-update. Backward: each again but
        # F(gt), which the gradient does not reach
        "fft": (2 * 2 * fft_wave + 2 * 3 * fft_psf
                + (3 + 2 * iters) * fft_image + (2 + 2 * iters) * fft_image),
        "divide": iters * (counts.freq_divide_ops(planes, s, s)
                           + DIVIDE_VJP_OPS_PER_ELEMENT * elems),
        "elementwise": (2 * (counts.FUSION_OPS_PER_ELEMENT + counts.ADMM_OPS_PER_ELEMENT
                             + XUPDATE_OPS_PER_ELEMENT) * iters * elems
                        + 2 * OPTIC_FIELD_OPS_PER_POINT * wave
                        + 2 * OTF_APPLY_OPS_PER_ELEMENT * 3 * padded * padded),
    }
    return {
        "flops_per_call": per_call,
        "ffdnet_conv_flops_per_call": per_call["ffdnet_conv"],
        "conv_peak_ops_per_s": counts.conv_peak(SPEC["tf32"]),
        "kernel_bound_s": {
            "tv_denoise_chw": counts.bound_s(tv_bytes(planes, s, s, tv_it),
                                             counts.tv_ops(planes, s, s, tv_it)),
            # a step of the adjoint recursion counted at the forward's operations
            "tv_denoise_chw_vjp": counts.bound_s(tv_bytes(planes, s, s, tv_it),
                                                 counts.tv_ops(planes, s, s, tv_it - 1)),
            # the divisor |H|^2 is one [3, s, s] plane set for the whole batch
            "freq_divide": counts.bound_s(counts.freq_divide_bytes(planes, s, s, 3 * s * s),
                                          counts.freq_divide_ops(planes, s, s)),
        },
    }

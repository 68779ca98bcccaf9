"""deconv_ffdnet: the port's flagship PnP-ADMM deconvolution.

sum_squares(conv(x, psf) - b) + deep_prior(x, "distilled_color_tv") by
admm: each iteration divides in frequency (cuFFT and the port's
``freq_divide`` kernel), then applies 0.6 FFDNet (color, 96 channels, 10
layers, cuDNN) + 0.4 TV (10 iterations, the port's ``tv_denoise_chw``
kernel). The sizes are in deconv_ffdnet.json; the plain reference is
``reference/``.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench import counts, workload
from portbench.case import Case
from portbench.reference import ops, solvers

SPEC = json.loads(Path(__file__).with_suffix(".json").read_text())


def build(traffic: dict, seed: int, device) -> Case:
    import dprox_tpu_torch as dp

    size, iters = traffic["size"], traffic["iterations"]
    psf = workload.gaussian_psf(SPEC["psf_size"], SPEC["psf_sigma"])
    b = workload.observations(traffic, seed, psf, device)
    rhos, lams = workload.schedule(traffic, device)
    weights = {k: v.to(device) for k, v in workload.ffdnet_weights(SPEC["weights"]).items()}

    x = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, psf[..., None]) - dp.Placeholder("b")),
                         dp.deep_prior(x, SPEC["prior"])], "admm", device=device)
    held = solver.psi_fns[0].denoiser.deep.module.state_dict()
    if held.keys() != weights.keys() or not all(torch.equal(held[k], weights[k]) for k in held):
        raise RuntimeError(f"the port's {SPEC['prior']} prior does not hold the weights of "
                           f"{SPEC['weights']} bit for bit")

    def call(j: int) -> torch.Tensor:
        bj = b[j]
        return solver.solve(x0=bj, rhos=rhos, lams=lams, max_iter=iters, params={"b": bj})

    H = ops.otf(psf, size, size, device)
    H2 = torch.abs(torch.conj(H) * H)
    w = SPEC["deep_weight"]

    def prior(v, lam):
        d = ops.ffdnet(weights, v, lam, SPEC["num_layers"], SPEC["residual"])
        t = ops.tv_denoise(v.reshape(-1, size, size), lam, SPEC["tv_iterations"]).reshape(v.shape)
        return w * d + (1 - w) * t

    def reference(j: int, control: bool = False) -> torch.Tensor:
        update = solvers.freq_xupdate(torch.conj(H) * torch.fft.fft2(b[j]), H2)
        with ops.tf32(control):
            return solvers.admm(b[j], rhos, lams, update, prior)

    return Case(call=call, reference=reference, images_per_call=traffic["batch"],
                iterations=iters, counts=work(traffic))


def work(traffic: dict) -> dict:
    """Operations per call and each kernel launch's bound, from shapes."""
    s, batch, iters = traffic["size"], traffic["batch"], traffic["iterations"]
    planes, tv_it = 3 * batch, SPEC["tv_iterations"]
    elems = planes * s * s
    conv = batch * counts.ffdnet_flops(SPEC["in_nc"], SPEC["nc"], SPEC["num_layers"], s, s)
    per_iter = {
        "ffdnet_conv": conv,
        "tv": counts.tv_ops(planes, s, s, tv_it),
        "fft": 2 * counts.fft2_flops(planes, s, s),
        "divide": counts.freq_divide_ops(planes, s, s),
        "elementwise": (counts.FUSION_OPS_PER_ELEMENT + counts.ADMM_OPS_PER_ELEMENT) * elems,
    }
    per_call = {k: iters * v for k, v in per_iter.items()}
    per_call["fft"] += counts.fft2_flops(planes, s, s)  # F(b), once a solve
    per_call["elementwise"] += 6 * elems               # conj(H) F(b)
    return {
        "flops_per_call": per_call,
        "ffdnet_conv_flops_per_call": per_call["ffdnet_conv"],
        "conv_peak_ops_per_s": counts.conv_peak(SPEC["tf32"]),
        "kernel_bound_s": {
            "tv_denoise_chw": counts.bound_s(counts.tv_bytes(planes, s, s),
                                             counts.tv_ops(planes, s, s, tv_it)),
            # the divisor |H|^2 is one [3, s, s] plane set for the whole batch
            "freq_divide": counts.bound_s(counts.freq_divide_bytes(planes, s, s, 3 * s * s),
                                          counts.freq_divide_ops(planes, s, s)),
        },
    }

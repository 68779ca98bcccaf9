"""jdd_ffdnet: joint demosaicking and deconvolution through the CG x-update.

sum_squares(mosaic(conv(x, psf)) - b) + deep_prior(x, "distilled_color") by
admm, as Delta-Prox's test_jd23: the x-update is not diagonal in space or
in frequency, so each one runs the port's preconditioned CG (cuFFT
matvecs, the frequency-Jacobi preconditioner, the ``bdot`` kernel and a
host read for each stop test), then color FFDNet (96 channels, 10 layers,
cuDNN). Each call starts from the user's bilinear demosaic of b. The sizes
are in jdd_ffdnet.json; the plain reference is ``reference/``.
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
    mask = ops.bayer_mask(size, size, device)
    b = mask * workload.observations(traffic, seed, psf, device)
    rhos, lams = workload.schedule(traffic, device)
    weights = {k: v.to(device) for k, v in workload.ffdnet_weights(SPEC["weights"]).items()}

    x = dp.Variable()
    data = dp.sum_squares(dp.mosaic(dp.conv(x, psf[..., None])) - dp.Placeholder("b"))
    solver = dp.compile(data + dp.deep_prior(x, SPEC["prior"]), "admm", device=device,
                        linear_solve_config=dp.LinearSolveConfig(
                            max_iters=SPEC["cg_max_iters"], rtol=SPEC["cg_rtol"]))
    held = solver.psi_fns[0].denoiser.module.state_dict()
    if held.keys() != weights.keys() or not all(torch.equal(held[k], weights[k]) for k in held):
        raise RuntimeError(f"the port's {SPEC['prior']} prior does not hold the weights of "
                           f"{SPEC['weights']} bit for bit")

    def call(j: int) -> torch.Tensor:
        bj = b[j]
        init = dp.utils.demosaic_from_mosaiced(bj)
        return solver.solve(x0=init, rhos=rhos, lams=lams, max_iter=iters, params={"b": bj})

    H = ops.otf(psf, size, size, device)
    K = lambda v: mask * ops.conv(v, H)  # noqa: E731
    Kt = lambda y: ops.conv_adjoint(mask * y, H)  # noqa: E731
    surrogate = mask.mean(dim=(-2, -1), keepdim=True) * torch.abs(torch.conj(H) * H)
    # the port's floor on CG's tolerance: below ~30 float32 eps the
    # preconditioned iteration amplifies round-off instead of converging
    rtol = max(SPEC["cg_rtol"], 30 * torch.finfo(torch.float32).eps)

    def prior(v, lam):
        return ops.ffdnet(weights, v, lam, SPEC["num_layers"], SPEC["residual"])

    weights_bf16 = {k: v.to(torch.bfloat16) for k, v in weights.items()}

    def prior_bf16(v, lam):
        return ops.ffdnet(weights_bf16, v.to(torch.bfloat16), lam.to(torch.bfloat16),
                          SPEC["num_layers"], SPEC["residual"]).float()

    def reference(j: int, control: bool = False) -> torch.Tensor:
        """As the configuration states (cuDNN in TF32), or in bfloat16: the
        network, and every vector that ADMM and CG store (torch has no
        bfloat16 FFT, so the FFTs' arithmetic stays float32)."""
        init = ops.demosaic_bilinear(b[j])
        if not control:
            update = solvers.cg_xupdate(K, Kt, Kt(b[j]), surrogate, rtol, SPEC["cg_max_iters"])
            with ops.tf32(SPEC["tf32"]):
                return solvers.admm(init, rhos, lams, update, prior)
        update = solvers.cg_xupdate(K, Kt, Kt(b[j]), surrogate, rtol, SPEC["cg_max_iters"], _bf16)
        return solvers.admm(_bf16(init), rhos, lams, update, prior_bf16, _bf16)

    return Case(call=call, reference=reference, images_per_call=traffic["batch"],
                iterations=iters, counts=work(traffic), observe=K)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def work(traffic: dict) -> dict:
    """Operations per call and each kernel launch's bound, from shapes.
    CG's inner iterations depend on the data: their operations are given
    per inner iteration, and a traced run counts the iterations."""
    s, batch, iters = traffic["size"], traffic["batch"], traffic["iterations"]
    planes, n = 3 * batch, 3 * s * s
    elems = batch * n
    fft = counts.fft2_flops(planes, s, s)
    conv = batch * counts.ffdnet_flops(SPEC["in_nc"], SPEC["nc"], SPEC["num_layers"], s, s)
    per_outer = {
        "ffdnet_conv": conv,
        # CG's set-up: r = K^T b + rho z - A x, z = M^-1 r, r.z
        "fft": counts.CG_SETUP_FFTS * fft,
        "elementwise": (counts.CG_SETUP_OPS_PER_ELEMENT + counts.ADMM_OPS_PER_ELEMENT) * elems,
    }
    per_call = {k: iters * v for k, v in per_outer.items()}
    per_call["fft"] += 2 * fft                          # K^T b, once a solve
    per_call["demosaic"] = counts.conv3x3_flops(1, 1, s, s) * planes
    return {
        "flops_per_call": per_call,
        "flops_per_cg_iteration": (counts.CG_ITERATION_FFTS * fft
                                   + counts.CG_ITERATION_OPS_PER_ELEMENT * elems),
        "ffdnet_conv_flops_per_call": per_call["ffdnet_conv"],
        "conv_peak_ops_per_s": counts.conv_peak(SPEC["tf32"]),
        "kernel_bound_s": {
            "bdot": counts.bound_s(counts.bdot_bytes(batch, n), counts.bdot_ops(batch, n)),
        },
    }

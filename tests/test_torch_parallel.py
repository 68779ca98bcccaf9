"""The port's multi-device layer (dprox_tpu_torch.parallel) in gloo worlds
on the CPU, against the JAX package on its virtual CPU mesh.

One 4-rank world runs every case of tests/test_parallel.py (1-D "batch"
and "space" meshes over the four ranks, and a 2 x 2 batch x space mesh
for the composite case) and counts each rank's collectives; a 2-rank
world runs the scenario-consensus LP of tests/test_multiprocess.py. The
ranks run tests/torch_parallel_worker.py (spawned, torch only) while this
process computes the same cases with the JAX package on a mesh of 4 of
its 8 virtual devices (2 x 2 for the composite case) and with the port on
one device. Same inputs on both sides (numpy, or the JAX package's
blurred images as numpy); each comparison at the tolerance of the
tests/test_parallel.py case it mirrors. The collective counts are those
tests/test_comm_counts.py holds the JAX package to.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import dprox_tpu as jdp
from dprox_tpu.algo.lp import solve_consensus_lp as jax_solve_consensus_lp
from dprox_tpu.contrib.energy_system import synthetic_cep_scenarios
from dprox_tpu.parallel import consensus_admm, create_mesh, distributed_cg, \
    sharded_denoise, shard_batch, solve_batched_sharded
from dprox_tpu.parallel.fft import make_distributed_fft2
from dprox_tpu.utils import imaging

import dprox_tpu_torch as dp
from dprox_tpu_torch.algo.lp import solve_consensus_lp
import torch_parallel_worker as worker

# tests/test_multiprocess.py's solve
LP_KW = dict(max_outer=40, eval_freq=20, tol=1e-3, inner_steps=4, pcg_iters=30, pcg_rtol=1e-5)


def local_prox(v, rho, a_i):
    # prox of f_i(x)=||x-a_i||^2 with weight rho/2 on ||x-v||^2
    return (2 * a_i + rho * v) / (2 + rho)


def _inputs():
    rng = np.random.RandomState(0)
    a = rng.rand(8, 4, 4).astype(np.float32)
    rng = np.random.RandomState(0)
    Ps = rng.rand(8, 16, 16).astype(np.float32)
    As = np.einsum("bij,bkj->bik", Ps, Ps) + 16 * np.eye(16, dtype=np.float32)
    xs = rng.rand(8, 16).astype(np.float32)
    bs = np.einsum("bij,bj->bi", As, xs)
    face = imaging.sample("face")
    psf5, psf15 = imaging.point_spread_function(5, 2), imaging.point_spread_function(15, 5)
    gray = face[:, :1, :256, :256]
    color = face[:, :, :256, :256]
    img128 = face[:, :, :128, :128]
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 64, 32).astype(np.float32)
    z = x + 1j * rng.rand(2, 3, 64, 32).astype(np.float32)
    arrays = {
        "consensus_a": a, "cg_As": As, "cg_bs": bs, "cg_xs": xs,
        "cg_b": np.random.RandomState(1).rand(8, 4).astype(np.float32),
        "psf5": psf5, "psf15": psf15,
        "b32": imaging.blurring(face[:, :, :32, :32], psf5),
        "noisy": gray + 0.1 * jax.random.normal(jax.random.key(0), gray.shape),
        "b_gray": imaging.blurring(gray, psf15), "b_color": imaging.blurring(color, psf15),
        "b_batch": imaging.blurring(jnp.concatenate([img128, jnp.flip(img128, axis=-1)]),
                                    psf15),
        "fft_x": x, "fft_z": z.astype(np.complex64),
    }
    return {k: np.asarray(v) for k, v in arrays.items()}


def _jax_cases(inp):
    """Every case on the JAX package's mesh of 4 virtual devices."""
    dev4 = np.array(jax.devices()[:4])
    mesh = create_mesh(("batch",), devices=dev4)
    smesh = create_mesh(("space",), devices=dev4)
    mesh2 = Mesh(dev4.reshape(2, 2), axis_names=("batch", "space"))
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    out = {"consensus_z": consensus_admm(local_prox, jnp.zeros((4, 4)), j["consensus_a"], mesh,
                                         max_iter=100, rho=1.0)}

    from jax import shard_map

    def block_cg(As_l, bs_l):  # tests/test_parallel.py::test_distributed_cg_block_diagonal
        def A_local(v):
            return jnp.einsum("bij,bj->bi", As_l, v)

        def gdot(p, q):
            return jax.lax.psum(jnp.vdot(p.ravel(), q.ravel()), "batch")

        x = jnp.zeros_like(bs_l)
        r = bs_l - A_local(x)
        rs = gdot(r, r)

        def it(c):
            x, r, p, rs, k = c
            Ap = A_local(p)
            alpha = rs / gdot(p, Ap)
            x, r = x + alpha * p, r - alpha * Ap
            rs2 = gdot(r, r)
            return x, r, r + (rs2 / rs) * p, rs2, k + 1

        return jax.lax.while_loop(lambda c: jnp.logical_and(c[4] < 200, c[3] > 1e-14), it,
                                  (x, r, r, rs, jnp.int32(0)))[0]

    out["cg_block_x"] = jax.jit(shard_map(block_cg, mesh=mesh, in_specs=(P("batch"),) * 2,
                                          out_specs=P("batch")))(
        shard_batch(j["cg_As"], mesh), shard_batch(j["cg_bs"], mesh))
    out["cg_helper_x"] = distributed_cg(lambda v: 3.0 * v, shard_batch(j["cg_b"], mesh), mesh,
                                        axis="batch", rtol=1e-10, max_iters=50)

    x = jdp.Variable()
    solver = jdp.compile([jdp.sum_squares(jdp.conv(x, inp["psf5"]) - j["b32"]), jdp.nonneg(x)],
                         method="admm")
    out["batched_x"] = solve_batched_sharded(solver, jnp.tile(j["b32"], (8, 1, 1, 1)), mesh,
                                             max_iter=6, rhos=0.05, lams=0.01)

    den = jdp.get_denoiser("tiny_ffdnet")
    out["denoise_y"] = jax.jit(lambda v: sharded_denoise(
        lambda blk: den.denoise(blk, 0.1), v, smesh, axis="space", halo=16))(j["noisy"])

    rhos, sigmas = jdp.log_descent(35, 10, 4)
    x = jdp.Variable()
    sh = jdp.compile([jdp.sum_squares(jdp.conv(x, inp["psf15"]) - j["b_gray"]),
                      jdp.deep_prior(x, "tiny_ffdnet", sqrt=True, spatial_mesh=smesh)], "admm")
    # eager, as tests/test_parallel.py runs it (an XLA CPU fft layout check
    # refuses the jitted program in host emulation)
    out["sharded_prior_x"] = sh.solve(x0=j["b_gray"], rhos=rhos, lams=sigmas, max_iter=4,
                                      jit=False)

    fft2, ifft2 = make_distributed_fft2(smesh, "space")
    xs = jax.device_put(j["fft_x"], NamedSharding(smesh, P(None, None, "space", None)))
    out["fft_F"] = jax.jit(fft2)(xs)
    out["fft_back"] = jax.jit(lambda v: ifft2(fft2(v)))(xs)
    zs = jax.device_put(j["fft_z"], NamedSharding(smesh, P(None, None, "space", None)))
    out["fft_Fz"] = jax.jit(fft2)(zs)

    x = jdp.Variable()
    sh = jdp.compile([jdp.sum_squares(jdp.conv(x, inp["psf15"]) - j["b_color"]),
                      jdp.deep_prior(x, "tiny_ffdnet_color", spatial_mesh=smesh,
                                     spatial_gather=False)], "admm", spatial_mesh=smesh)
    with smesh:
        out["fully_sharded_x"] = sh.solve(x0=j["b_color"], rhos=rhos, lams=sigmas, max_iter=4)

    x, y = jdp.Variable(), jdp.Placeholder("y")
    sh = jdp.compile([jdp.sum_squares(jdp.conv(x, inp["psf15"]) - y),
                      jdp.deep_prior(x, "tiny_ffdnet_color", spatial_mesh=mesh2,
                                     spatial_gather=False, spatial_batch_axis="batch")],
                     "admm", spatial_mesh=mesh2, spatial_batch_axis="batch")
    with mesh2:
        b_sh = jax.device_put(j["b_batch"], NamedSharding(mesh2, P("batch", None, "space", None)))
        out["composite_x"] = sh.solve(x0=b_sh, rhos=rhos, lams=sigmas, max_iter=4,
                                      params={"y": b_sh})
    return {k: np.asarray(v) for k, v in out.items()}


def _port_single(inp):
    """The cases on one device in the port (the unsharded references)."""
    t = {k: torch.from_numpy(v.copy()) for k, v in inp.items()}
    rhos, sigmas = dp.log_descent(35, 10, 4)
    x = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(x, inp["psf5"]) - t["b32"]), dp.nonneg(x)],
                        method="admm", device="cpu")
    out = {"batched_x": solver.solve(x0=t["b32"], max_iter=6, rhos=0.05, lams=0.01),
           "denoise_y": dp.get_denoiser("tiny_ffdnet").denoise(t["noisy"], 0.1)}
    x = dp.Variable()
    ref = dp.compile([dp.sum_squares(dp.conv(x, inp["psf15"]) - t["b_gray"]),
                      dp.deep_prior(x, "tiny_ffdnet", sqrt=True)], "admm", device="cpu")
    out["sharded_prior_x"] = ref.solve(x0=t["b_gray"], rhos=rhos, lams=sigmas, max_iter=4)
    x = dp.Variable()
    ref = dp.compile([dp.sum_squares(dp.conv(x, inp["psf15"]) - t["b_color"]),
                      dp.deep_prior(x, "tiny_ffdnet_color")], "admm", device="cpu")
    out["fully_sharded_x"] = ref.solve(x0=t["b_color"], rhos=rhos, lams=sigmas, max_iter=4)
    x, y = dp.Variable(), dp.Placeholder("y")
    ref = dp.compile([dp.sum_squares(dp.conv(x, inp["psf15"]) - y),
                      dp.deep_prior(x, "tiny_ffdnet_color")], "admm", device="cpu")
    out["composite_x"] = ref.solve(x0=t["b_batch"], rhos=rhos, lams=sigmas, max_iter=4,
                                   params={"y": t["b_batch"]})
    return {k: v.detach().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both worlds, compute the JAX and single-device references while
    they run, then collect what the ranks wrote."""
    inp = _inputs()
    work = {name: tmp_path_factory.mktemp(name) for name in ("parallel", "lp")}
    np.savez(work["parallel"] / "inputs.npz", **inp)
    worlds = [worker.start_world(worker.parallel_cases, 4, work["parallel"]),
              worker.start_world(worker.consensus_lp, 2, work["lp"], json.dumps(LP_KW))]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref_jax, ref_port = _jax_cases(inp), _port_single(inp)
        c, A_ub, A_eq, b_ub, b_eq_s, sh = synthetic_cep_scenarios(8, 3, 8)
        lp_port = solve_consensus_lp(c, A_ub, b_ub, A_eq, b_eq_s, sh, dtype=torch.float32,
                                     device="cpu", **LP_KW)[3]
        lp_jax = jax_solve_consensus_lp(c, A_ub, b_ub, A_eq, b_eq_s, sh, mesh=None,
                                        dtype=jnp.float32, **LP_KW)[3]
    finally:
        torch.set_num_threads(threads)
        for w in worlds:
            worker.join_world(w)

    def load(name):
        with open(os.path.join(work[name], name + ".json")) as f:
            counts = json.load(f)
        return counts, dict(np.load(os.path.join(work[name], name + ".npz")))

    counts, got = load("parallel")
    lp_counts, _ = load("lp")
    lp_ranks = [dict(np.load(os.path.join(work["lp"], f"lp_rank{r}.npz"))) for r in range(2)]
    return dict(inp=inp, got=got, counts=counts, jax=ref_jax, port=ref_port, lp_ranks=lp_ranks,
                lp_counts=lp_counts, lp_port=lp_port, lp_jax=lp_jax)


def test_consensus_admm_averaging(runs):
    z = runs["got"]["consensus_z"]
    assert np.allclose(z, runs["inp"]["consensus_a"].mean(0), atol=1e-3)
    assert np.allclose(z, runs["jax"]["consensus_z"], atol=1e-3)


def test_distributed_cg_block_diagonal(runs):
    x = runs["got"]["cg_block_x"]
    assert np.allclose(x, runs["inp"]["cg_xs"], atol=1e-2)
    assert np.allclose(x, runs["jax"]["cg_block_x"], atol=1e-2)


def test_distributed_cg_helper(runs):
    x = runs["got"]["cg_helper_x"]
    assert np.allclose(x, runs["inp"]["cg_b"] / 3.0, atol=1e-5)
    assert np.allclose(x, runs["jax"]["cg_helper_x"], atol=1e-5)


def test_sharded_batched_solve_matches_single(runs):
    x = runs["got"]["batched_x"]
    assert x.shape[0] == 8
    for i in range(8):  # each rank's two images
        assert np.allclose(x[i], runs["port"]["batched_x"][0], atol=1e-4)
    assert np.allclose(x, runs["jax"]["batched_x"], atol=1e-4)


def test_sharded_denoise_exact_vs_unsharded(runs):
    y = runs["got"]["denoise_y"]
    assert y.shape == runs["inp"]["noisy"].shape
    assert np.allclose(y, runs["port"]["denoise_y"], atol=2e-5)
    assert np.allclose(y, runs["jax"]["denoise_y"], atol=2e-5)


def test_pnp_solve_with_sharded_prior_matches_unsharded(runs):
    assert int(runs["got"]["prior_halo"]) == 16  # the denoiser's receptive_radius
    x = runs["got"]["sharded_prior_x"]
    assert np.allclose(x, runs["port"]["sharded_prior_x"], atol=5e-4)
    assert np.allclose(x, runs["jax"]["sharded_prior_x"], atol=5e-4)


def test_distributed_fft2_matches_local(runs):
    got, inp = runs["got"], runs["inp"]
    for ref in (np.fft.fftn(inp["fft_x"], axes=(-2, -1)), runs["jax"]["fft_F"]):
        np.testing.assert_allclose(got["fft_F"], ref, atol=1e-4)
    np.testing.assert_allclose(np.real(got["fft_back"]), inp["fft_x"], atol=1e-5)
    for ref in (np.fft.fftn(inp["fft_z"], axes=(-2, -1)), runs["jax"]["fft_Fz"]):
        np.testing.assert_allclose(got["fft_Fz"], ref, atol=1e-4)


def test_fully_sharded_pnp_admm(runs):
    x = runs["got"]["fully_sharded_x"]
    assert np.abs(x - runs["port"]["fully_sharded_x"]).max() < 5e-5
    assert np.abs(x - runs["jax"]["fully_sharded_x"]).max() < 5e-5


def test_composite_batch_space_sharded_solve(runs):
    x = runs["got"]["composite_x"]
    assert x.shape == (2, 3, 128, 128)
    assert np.abs(x - runs["port"]["composite_x"]).max() < 5e-5
    assert np.abs(x - runs["jax"]["composite_x"]).max() < 5e-5


@pytest.mark.parametrize("case,match", [
    ("error_H", "H=66 not divisible by mesh axis 4"),
    ("error_small", r"local height 16 < 2\*halo=32"),
    ("error_fft_H", "dim 2 of size 66 not divisible"),
    ("error_cuda_mesh", "a cuda mesh needs a nccl process group"),
    ("error_device", "a meta tensor on a cpu mesh"),
    ("error_batch", "batch 6 must divide the 4-rank axis 'batch'")])
def test_wrong_shapes_and_backends_raise(runs, case, match):
    import re

    assert re.search(match, str(runs["got"][case])), runs["got"][case]


def test_distributed_fft2_one_all_to_all_each_way(runs):
    for c in runs["counts"]:
        assert c["fft2"] == {"all_to_all_single": 1}, c
        assert c["fft2_ifft2"] == {"all_to_all_single": 2}, c
        assert c["composite_fft2_ifft2"] == {"all_to_all_single": 2}, c


def test_sharded_denoise_one_send_recv_pair_per_neighbour(runs):
    for rank, c in enumerate(runs["counts"]):
        nb = 1 if rank in (0, 3) else 2  # the edge blocks have one neighbour
        assert c["sharded_denoise"] == {"batch_isend_irecv": 1, "p2p_isend": nb,
                                        "p2p_irecv": nb}, (rank, c)
        # 2 x 2 mesh: each space sub-group is two ranks, one neighbour each
        assert c["composite_sharded_denoise"] == {"batch_isend_irecv": 1, "p2p_isend": 1,
                                                  "p2p_irecv": 1}, (rank, c)


def test_consensus_admm_one_all_reduce_per_iteration(runs):
    for c in runs["counts"]:
        assert c["consensus_admm_100"] == {"all_reduce_SUM": 100}, c


def test_batch_sharded_solve_zero_collectives(runs):
    for c in runs["counts"]:
        assert c["batched_solve"] == {}, c


def test_fully_sharded_solve_collectives(runs):
    """Four iterations: the hoisted F(b) and a forward and an inverse
    transform an iteration (one all-to-all each), one halo exchange an
    iteration; the loop between them adds nothing."""
    for rank, c in enumerate(runs["counts"]):
        nb = 1 if rank in (0, 3) else 2
        assert c["fully_sharded_4"] == {"all_to_all_single": 1 + 2 * 4, "batch_isend_irecv": 4,
                                        "p2p_isend": 4 * nb, "p2p_irecv": 4 * nb}, (rank, c)


def test_consensus_lp_ranks_agree_and_match_single_process(runs):
    r0, r1 = runs["lp_ranks"]
    assert np.isfinite(r0["objective"])
    assert r0["objective"] == r1["objective"]
    assert r0["zsum"] == r1["zsum"]
    assert np.array_equal(r0["z"], r1["z"]) and np.array_equal(r0["xs"], r1["xs"])
    for ref in (runs["lp_port"]["objective"], runs["lp_jax"]["objective"]):
        assert float(r0["objective"]) == pytest.approx(ref, rel=1e-3)


def test_consensus_lp_one_all_reduce_per_outer_iteration(runs):
    """The consensus mean once an outer iteration; each chunk's
    diagnostics add the objective's mean and two maxima; the final x is
    gathered once."""
    r0 = runs["lp_ranks"][0]
    outer, chunks = int(r0["outer_iters"]), int(r0["chunks"])
    for c in runs["lp_counts"]:
        assert c == {"all_reduce_SUM": outer + chunks, "all_reduce_MAX": 2 * chunks,
                     "all_gather": 1}, c


def test_consensus_lp_scenarios_not_dividing_the_mesh_raise(runs):
    for r in runs["lp_ranks"]:
        assert "n_scenarios=3 must divide over the 2-rank mesh axis" in str(r["error_S"])

"""Rank programs of the port's multi-device tests: gloo worlds on the CPU.

``start_world(target, nprocs, workdir, *args)`` starts ``nprocs`` ranks
with the spawn context (the test process has JAX loaded; forking it can
deadlock), joins them in a gloo world through a FileStore in ``workdir``
and runs ``target(rank, world, workdir, *args)`` on each rank with torch
pinned to one thread. The rank programs below read their inputs from
``workdir/inputs.npz`` and write their results there for the test process
to compare with JAX. This module imports torch and dprox_tpu_torch only,
never JAX.

Each rank program counts the collectives it calls (``Collectives``) by
wrapping the ``torch.distributed`` functions, and the functional
collectives DTensor uses, for the span of one call.
"""
from __future__ import annotations

import json
import os
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# isend / irecv stay unwrapped: P2POp accepts only those two functions;
# a batch_isend_irecv counts the sends and receives it posts
_DIST_FNS = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
             "all_to_all_single", "broadcast", "reduce_scatter", "reduce_scatter_tensor",
             "send", "recv", "barrier")
_FUNCOL_FNS = ("all_reduce", "all_gather_tensor", "reduce_scatter_tensor", "all_to_all_single",
               "broadcast", "permute_tensor")


def start_world(target, nprocs: int, workdir: str, *args):
    """Start the ranks; returns the process context (``join_world``)."""
    return mp.start_processes(_rank_main, args=(target, nprocs, str(workdir), args),
                              nprocs=nprocs, join=False, start_method="spawn")


def join_world(context, timeout: float = 400.0):
    """Wait for every rank (raising a rank's exception), at most
    ``timeout`` seconds, then end the ranks still running and raise."""
    deadline = time.monotonic() + timeout
    while not context.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


def run_world(target, nprocs: int, workdir: str, *args, timeout: float = 400.0):
    join_world(start_world(target, nprocs, workdir, *args), timeout)


def _rank_main(rank, target, world, workdir, args):
    torch.set_num_threads(1)
    store = os.path.join(workdir, f"rendezvous_{target.__name__}")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        target(rank, world, workdir, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


class Collectives:
    """Counts the collective calls of this rank inside ``with counts:``;
    a ``batch_isend_irecv`` also counts each send and receive it posts
    (``p2p_isend`` / ``p2p_irecv``)."""

    def __init__(self):
        import torch.distributed._functional_collectives as funcol

        self.counts = Counter()
        self._active = False
        self._saved = []
        for mod, names, prefix in ((dist, _DIST_FNS, ""), (funcol, _FUNCOL_FNS, "funcol_")):
            for name in names:
                fn = getattr(mod, name, None)
                if fn is not None:
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._wrap(prefix + name, fn))
        batch = dist.batch_isend_irecv
        self._saved.append((dist, "batch_isend_irecv", batch))

        def counted_batch(ops):
            if self._active:
                self.counts["batch_isend_irecv"] += 1
                for op in ops:
                    self.counts["p2p_" + op.op.__name__] += 1
            return batch(ops)

        dist.batch_isend_irecv = counted_batch

    def _wrap(self, name, fn):
        def counted(*a, **k):
            if self._active:
                key = name
                if name == "all_reduce":  # by reduction: all_reduce_SUM, all_reduce_MAX
                    op = k.get("op", a[1] if len(a) > 1 else dist.ReduceOp.SUM)
                    key += "_" + str(op).split(".")[-1]
                self.counts[key] += 1
            return fn(*a, **k)

        return counted

    def __enter__(self):
        self.counts = Counter()
        self._active = True
        return self

    def __exit__(self, *exc):
        self._active = False

    def restore(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _gathered(x):
    return x.full_tensor().numpy() if hasattr(x, "full_tensor") else np.asarray(x)


def _raises(fn):
    """The message of the ValueError / RuntimeError ``fn`` raises, else ''."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _write(rank, workdir, name, out, counts):
    """Every rank's counts go to rank 0, which writes ``name``.npz and
    ``name``.json (counts by rank)."""
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, counts)
    if rank == 0:
        np.savez(os.path.join(workdir, name + ".npz"), **out)
        with open(os.path.join(workdir, name + ".json"), "w") as f:
            json.dump(gathered, f)


def parallel_cases(rank, world, workdir):
    """Every case of tests/test_parallel.py on 4 ranks: 1-D meshes "batch"
    and "space" over all of them and a 2 x 2 ("batch", "space") mesh."""
    import dprox_tpu_torch as dp
    from dprox_tpu_torch.parallel import (consensus_admm, create_mesh, distributed_cg,
                                          shard_batch, sharded_denoise, solve_batched_sharded)
    from dprox_tpu_torch.parallel.fft import make_distributed_fft2
    from dprox_tpu_torch.parallel.mesh import from_local, local_shard

    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    mesh = create_mesh(("batch",), device_type="cpu")
    smesh = create_mesh(("space",), device_type="cpu")
    mesh2 = create_mesh(("batch", "space"), shape=(2, 2), device_type="cpu")
    coll = Collectives()
    out, counts = {}, {}

    def local_prox(v, rho, a_i):
        return (2 * a_i + rho * v) / (2 + rho)

    with coll:
        z = consensus_admm(local_prox, torch.zeros(4, 4), t["consensus_a"], mesh,
                           max_iter=100, rho=1.0)
    counts["consensus_admm_100"] = dict(coll.counts)
    out["consensus_z"] = _gathered(z)

    As_l = shard_batch(t["cg_As"], mesh).to_local()
    x = distributed_cg(lambda v: torch.einsum("bij,bj->bi", As_l, v),
                       shard_batch(t["cg_bs"], mesh), mesh, axis="batch", rtol=1e-7,
                       max_iters=200)
    out["cg_block_x"] = _gathered(x)
    x = distributed_cg(lambda v: 3.0 * v, shard_batch(t["cg_b"], mesh), mesh, axis="batch",
                       rtol=1e-10, max_iters=50)
    out["cg_helper_x"] = _gathered(x)

    xv = dp.Variable()
    psf5 = inp["psf5"]
    solver = dp.compile([dp.sum_squares(dp.conv(xv, psf5) - t["b32"]), dp.nonneg(xv)],
                        method="admm", device="cpu")
    with coll:
        xs = solve_batched_sharded(solver, t["b32"].repeat(8, 1, 1, 1), mesh, max_iter=6,
                                   rhos=0.05, lams=0.01)
    counts["batched_solve"] = dict(coll.counts)
    out["batched_x"] = _gathered(xs)

    den = dp.get_denoiser("tiny_ffdnet")
    with coll:
        y = sharded_denoise(lambda blk: den.denoise(blk, 0.1), t["noisy"], smesh,
                            axis="space", halo=16)
    counts["sharded_denoise"] = dict(coll.counts)
    out["denoise_y"] = _gathered(y)
    out["error_H"] = _raises(lambda: sharded_denoise(lambda b: b, torch.zeros(1, 1, 66, 8),
                                                     smesh, halo=1))
    out["error_small"] = _raises(lambda: sharded_denoise(lambda b: b, torch.zeros(1, 1, 64, 8),
                                                         smesh, halo=16))
    out["error_cuda_mesh"] = _raises(lambda: create_mesh(("space",), device_type="cuda"))
    out["error_device"] = _raises(lambda: sharded_denoise(
        lambda b: b, torch.zeros(1, 1, 64, 8, device="meta"), smesh, halo=1))
    out["error_batch"] = _raises(lambda: solve_batched_sharded(
        solver, t["b32"].repeat(6, 1, 1, 1), mesh, max_iter=1))

    psf15 = inp["psf15"]
    rhos, sigmas = dp.log_descent(35, 10, 4)
    xv = dp.Variable()
    prior = dp.deep_prior(xv, "tiny_ffdnet", sqrt=True, spatial_mesh=smesh)
    out["prior_halo"] = prior.spatial_halo
    sh = dp.compile([dp.sum_squares(dp.conv(xv, psf15) - t["b_gray"]), prior], "admm",
                    device="cpu")
    out["sharded_prior_x"] = _gathered(sh.solve(x0=t["b_gray"], rhos=rhos, lams=sigmas,
                                                max_iter=4))

    fft2, ifft2 = make_distributed_fft2(smesh, "space")
    with coll:
        F = fft2(t["fft_x"])
    counts["fft2"] = dict(coll.counts)
    with coll:
        back = ifft2(fft2(t["fft_x"]))
    counts["fft2_ifft2"] = dict(coll.counts)
    out["fft_F"] = _gathered(F)
    out["fft_back"] = _gathered(back)
    out["fft_Fz"] = _gathered(fft2(t["fft_z"]))
    out["error_fft_H"] = _raises(lambda: fft2(torch.zeros(1, 1, 66, 8)))

    xv = dp.Variable()
    sh = dp.compile([dp.sum_squares(dp.conv(xv, psf15) - t["b_color"]),
                     dp.deep_prior(xv, "tiny_ffdnet_color", spatial_mesh=smesh,
                                   spatial_gather=False)],
                    "admm", device="cpu", spatial_mesh=smesh)
    with coll:
        xs = sh.solve(x0=t["b_color"], rhos=rhos, lams=sigmas, max_iter=4)
    counts["fully_sharded_4"] = dict(coll.counts)
    out["fully_sharded_x"] = _gathered(xs)

    xv, yv = dp.Variable(), dp.Placeholder("y")
    sh = dp.compile([dp.sum_squares(dp.conv(xv, psf15) - yv),
                     dp.deep_prior(xv, "tiny_ffdnet_color", spatial_mesh=mesh2,
                                   spatial_gather=False, spatial_batch_axis="batch")],
                    "admm", device="cpu", spatial_mesh=mesh2, spatial_batch_axis="batch")
    dims = {"batch": 0, "space": 2}
    b_sh = from_local(local_shard(t["b_batch"], mesh2, dims), mesh2, dims)
    out["composite_x"] = _gathered(sh.solve(x0=b_sh, rhos=rhos, lams=sigmas, max_iter=4,
                                            params={"y": b_sh}))
    fft2b, ifft2b = make_distributed_fft2(mesh2, "space", batch_axis="batch")
    with coll:
        ifft2b(fft2b(torch.zeros(2, 3, 64, 64, dtype=torch.complex64)))
    counts["composite_fft2_ifft2"] = dict(coll.counts)
    with coll:
        sharded_denoise(lambda blk: blk * 2.0, torch.zeros(2, 1, 64, 64), mesh2, axis="space",
                        halo=4, batch_axis="batch")
    counts["composite_sharded_denoise"] = dict(coll.counts)
    coll.restore()
    _write(rank, workdir, "parallel", out, counts)


def consensus_lp(rank, world, workdir, kwargs_json):
    """The scenario-consensus LP over a ``world``-rank "scenario" mesh on
    tests/test_multiprocess.py's instance; each rank writes its objective
    and sum(z). Also: a scenario count that does not divide the mesh
    raises."""
    from dprox_tpu_torch.algo.lp import solve_consensus_lp
    from dprox_tpu_torch.contrib.energy_system import synthetic_cep_scenarios
    from dprox_tpu_torch.parallel import create_mesh

    kw = json.loads(kwargs_json)
    mesh = create_mesh(("scenario",), device_type="cpu")
    c, A_ub, A_eq, b_ub, b_eq_s, sh = synthetic_cep_scenarios(8, 3, 8)
    coll = Collectives()
    with coll:
        z, xs, hist, res = solve_consensus_lp(c, A_ub, b_ub, A_eq, b_eq_s, sh, mesh=mesh,
                                              dtype=torch.float32, device="cpu", **kw)
    counts = dict(coll.counts)
    coll.restore()
    out = {"objective": res["objective"], "zsum": float(np.sum(z)), "z": z, "xs": xs,
           "outer_iters": res["outer_iters"], "chunks": len(hist["objective"]),
           "error_S": _raises(lambda: solve_consensus_lp(
               c, A_ub, b_ub, A_eq, b_eq_s[:world + 1], sh, mesh=mesh, dtype=torch.float32,
               device="cpu", max_outer=1))}
    np.savez(os.path.join(workdir, f"lp_rank{rank}.npz"), **out)
    _write(rank, workdir, "lp", {}, counts)


def mesh_not_dividing(rank, world, workdir, n_periods, n_tech, S):
    """Each consensus-LP entry with a mesh whose size does not divide the
    scenario count: the message it raises (rank 0 writes them)."""
    from dprox_tpu_torch.algo import lp
    from dprox_tpu_torch.contrib.energy_system import synthetic_cep_scenarios
    from dprox_tpu_torch.parallel import create_mesh

    mesh = create_mesh(("scenario",), device_type="cpu")
    c, A_ub, A_eq, b_ub, b_eq_s, sh = synthetic_cep_scenarios(n_periods, n_tech, S)
    p = lp.ScenarioLP(c, A_ub, b_ub, A_eq, b_eq_s, sh, device="cpu")
    out = {
        "solve": _raises(lambda: lp.ConsensusLPSolver().solve(p, mesh=mesh)),
        "solve_fused": _raises(lambda: lp.ConsensusLPSolver().solve_fused(p, mesh=mesh)),
        "solve_consensus_lp": _raises(lambda: lp.solve_consensus_lp(
            c, A_ub, b_ub, A_eq, b_eq_s, sh, mesh=mesh, device="cpu")),
    }
    if rank == 0:
        with open(os.path.join(workdir, "mesh_not_dividing.json"), "w") as f:
            json.dump(out, f)

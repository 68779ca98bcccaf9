"""Consensus ADMM and the data-parallel batched solve over a mesh.

Counterpart of dprox_tpu/parallel/consensus.py. ``consensus_admm`` solves
block-separable problems

    min_x  sum_i f_i(x)        (blocks i sharded over the mesh axis)

by global-variable consensus ADMM: each rank updates its blocks' local
primal variables with the block prox, the consensus variable is the mean
of (x_i + u_i) over every block (one SUM all-reduce an iteration, divided
by the axis size: the JAX package's pmean of equal shards), and the duals
update locally. ``solve_batched_sharded`` runs the whole solver on each
rank's slice of the batch, with no collective at all.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from .mesh import axis_size, check_device, from_local, local_shard


def consensus_admm(local_prox: Callable, z0, local_args, mesh, axis: str = "batch",
                   max_iter: int = 50, rho: float = 1.0):
    """Run consensus ADMM with ``local_prox(v, rho, block_args) -> x``.

    z0: replicated initial consensus variable [*shape] (a DTensor or a
    plain tensor). local_args: pytree with a leading block axis (n_blocks
    in all, sharded over ``axis``: DTensors, or global values each rank
    slices); each rank vmaps the prox over its blocks.

    Returns the consensus z after ``max_iter`` iterations, a replicated
    DTensor.
    """
    group, n = mesh.get_group(axis), axis_size(mesh, axis)
    z = local_shard(z0, mesh, {})
    check_device(z, mesh)
    args_l = tree_map(lambda a: local_shard(a, mesh, {axis: 0}), local_args)
    n_local = tree_leaves(args_l)[0].shape[0]
    x = z.expand((n_local,) + tuple(z.shape)).clone()
    u = torch.zeros_like(x)
    prox = torch.vmap(lambda vv, aa: local_prox(vv, rho, aa))
    for _ in range(max_iter):
        x = prox(z[None] - u, args_l)
        # consensus: mean over the local blocks, then the mean over ranks
        z = torch.mean(x + u, dim=0)
        dist.all_reduce(z, op=dist.ReduceOp.SUM, group=group)
        z = z / n
        u = u + x - z[None]
    return from_local(z, mesh, {})


def solve_batched_sharded(solver, x0, mesh, params: Optional[dict] = None,
                          axis: str = "batch", max_iter: int = 24, rhos=None, lams=None,
                          **solve_kwargs):
    """Data-parallel solve: the batch is sharded over ``axis`` and each rank
    runs the whole solver on its slice, with no collective (counted in
    tests/test_torch_parallel.py). x0: [B, ...] DTensor or global value;
    ``params`` values with a leading dim of B are sliced like x0, the
    others go whole to every rank. Returns the solution as a DTensor
    sharded like x0."""
    B = x0.shape[0]
    n = axis_size(mesh, axis)
    if B % n:
        raise ValueError(f"batch {B} must divide the {n}-rank axis {axis!r}")
    x0_l = local_shard(x0, mesh, {axis: 0})
    params_l = {k: local_shard(v, mesh, {axis: 0})
                if getattr(v, "ndim", 0) >= 1 and v.shape[0] == B else v
                for k, v in (params or {}).items()}
    out = solver.solve(x0=x0_l, rhos=rhos, lams=lams, max_iter=max_iter, params=params_l,
                       **solve_kwargs)
    return from_local(out, mesh, {axis: 0})

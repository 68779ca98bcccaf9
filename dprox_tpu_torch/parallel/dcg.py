"""Distributed conjugate gradient: shard-local matvecs, all-reduced dots.

Counterpart of dprox_tpu/parallel/dcg.py. The inner products of CG
reduce over every element, so they split into per-shard partial sums and
one SUM all-reduce over the mesh axis's group. Use this when a single
linear system spans ranks (the unknown itself is sharded: a spatially
sharded image, a scenario-stacked system).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .mesh import check_device, from_local, local_shard


def distributed_cg(A_local: Callable, b, mesh, axis: str = "shard",
                   spec: Optional[Dict[str, int]] = None, rtol: float = 1e-6,
                   max_iters: int = 100):
    """Solve A x = b where x and b are sharded over ``axis`` and
    ``A_local`` computes the shard-local rows of A x from the local shard
    (a halo exchange, if any, is A_local's business).

    ``spec``: {mesh axis: tensor dim} of the sharding (default: dim 0 over
    ``axis``). b is a DTensor or a global value that each rank slices.
    The iteration stops after ``max_iters`` or once ||r||^2 <= rtol^2
    ||b||^2, on every rank alike (each reads the same all-reduced values).
    Returns x as a DTensor placed like b.
    """
    dims = spec if spec is not None else {axis: 0}
    group = mesh.get_group(axis)
    b_l = local_shard(b, mesh, dims)
    check_device(b_l, mesh)

    def gdot(p, q):
        d = torch.vdot(p.reshape(-1), q.reshape(-1))
        dist.all_reduce(d, op=dist.ReduceOp.SUM, group=group)
        return d

    x = torch.zeros_like(b_l)
    r = b_l - A_local(x)
    p = r
    rs = gdot(r, r)
    tol2 = (rtol ** 2) * torch.clamp(gdot(b_l, b_l), min=1e-32)
    k = 0
    while k < max_iters and bool(rs > tol2):
        Ap = A_local(p)
        alpha = rs / torch.clamp(gdot(p, Ap), min=1e-32)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = gdot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-32)
        p = r + beta * p
        rs = rs_new
        k += 1
    return from_local(x, mesh, dims)

"""Spatially sharded denoiser inference with halo exchange.

Counterpart of dprox_tpu/parallel/spatial.py. The image's height is
sharded over a mesh axis and each rank exchanges ``2*halo`` boundary rows
with its neighbours (one ``batch_isend_irecv`` a call: a send and a
receive per neighbour), so each block's convolution receptive fields see
true neighbour pixels.

Boundary handling matters for exactness: synthetic zero halos at the
outer image boundary would not reproduce the network's own SAME padding
(zeros fed as data acquire bias activations through deep layers).
Instead, an edge block takes a one-sided ``2*halo`` rows from its single
neighbour and no synthetic padding, so the network's own boundary
behaviour applies at the true image edge. With ``halo`` at least the
network's receptive-field radius the sharded result is the unsharded
one (tests/test_torch_parallel.py).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import axis_size, check_device, from_local, local_shard


def _exchange(x_l: torch.Tensor, group, idx: int, n: int, halo: int):
    """(rows from the block above, rows from the block below): the
    neighbours' last and first ``2*halo`` rows, None at an edge."""
    ops, from_above, from_below = [], None, None
    if idx > 0:
        above = dist.get_global_rank(group, idx - 1)
        from_above = torch.empty_like(x_l[:, :, :2 * halo])
        ops += [dist.P2POp(dist.isend, x_l[:, :, :2 * halo].contiguous(), above, group),
                dist.P2POp(dist.irecv, from_above, above, group)]
    if idx < n - 1:
        below = dist.get_global_rank(group, idx + 1)
        from_below = torch.empty_like(x_l[:, :, -2 * halo:])
        ops += [dist.P2POp(dist.isend, x_l[:, :, -2 * halo:].contiguous(), below, group),
                dist.P2POp(dist.irecv, from_below, below, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_above, from_below


def sharded_denoise(denoise_fn: Callable, x, mesh, axis: str = "space", halo: int = 16,
                    batch_axis: Optional[str] = None):
    """Apply ``denoise_fn(x_block) -> y_block`` ([B,C,h,W] -> same) to an
    image sharded along H over ``axis``.

    x: [B,C,H,W] (a DTensor, or a global value that each rank slices to
    its rows) with H divisible by the axis size n, and H/n >= 2*halo.
    ``halo`` must cover the network's receptive-field radius (keep it a
    multiple of any pixel-unshuffle factor). Returns a [B,C,H,W] DTensor
    sharded along H over ``axis``; with one rank on the axis that is
    ``denoise_fn`` of the whole block.

    ``batch_axis``: also shard B over this mesh axis (composite batch x
    space on a 2-D mesh). The halo exchange still runs only within each
    ``axis`` sub-group.
    """
    n = axis_size(mesh, axis)
    if x.shape[2] % n:
        raise ValueError(f"H={x.shape[2]} not divisible by mesh axis {n}")
    h_local = x.shape[2] // n
    if n > 1 and h_local < 2 * halo:
        raise ValueError(f"local height {h_local} < 2*halo={2 * halo}; "
                         "use fewer devices or a smaller halo")
    dims = {**({batch_axis: 0} if batch_axis else {}), axis: 2}
    x_l = local_shard(x, mesh, dims)
    check_device(x_l, mesh)
    if n == 1:
        return from_local(denoise_fn(x_l), mesh, dims)
    group, idx = mesh.get_group(axis), mesh.get_local_rank(axis)
    from_above, from_below = _exchange(x_l, group, idx, n, halo)
    # interior blocks use half of the 2*halo rows on each side; edge
    # blocks use all of them one-sided (no synthetic pad)
    if idx == 0:
        padded, start = torch.cat([x_l, from_below], dim=2), 0
    elif idx == n - 1:
        padded, start = torch.cat([from_above, x_l], dim=2), 2 * halo
    else:
        padded = torch.cat([from_above[:, :, -halo:], x_l, from_below[:, :, :halo]], dim=2)
        start = halo
    out = denoise_fn(padded)
    return from_local(out[:, :, start:start + h_local].contiguous(), mesh, dims)

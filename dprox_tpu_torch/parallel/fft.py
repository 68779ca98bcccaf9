"""Distributed 2-D FFT: one image spans the mesh in the solve loop.

Counterpart of dprox_tpu/parallel/fft.py. The 2-D FFT of an H-sharded
image decomposes into

    local row FFTs (along W) -> one all-to-all transpose -> local column FFTs

so the only communication is one ``all_to_all_single`` per transform, on
the axis's process group. The spectrum comes out W-sharded; pointwise
work there (the x-update's divide) needs no further communication, and
the inverse transform mirrors the decomposition back to H-sharded space.

``all_to_all_single`` splits and concatenates dim 0, so each exchange
moves the split axis to the front, exchanges a contiguous buffer and
moves the received blocks back. A complex spectrum travels as
``torch.view_as_real`` of it: NCCL has no complex types.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import axis_size, check_device, from_local, local_shard


def _all_to_all(xl: torch.Tensor, group, n: int, split: int, concat: int) -> torch.Tensor:
    """``jax.lax.all_to_all(xl, split_axis=split, concat_axis=concat,
    tiled=True)`` over ``group``: dim ``split`` is cut into ``n`` blocks,
    block j goes to the group's rank j, and the blocks received are laid
    side by side along ``concat`` in rank order."""
    shape = list(xl.shape)
    blocks = xl.unflatten(split, (n, shape[split] // n)).movedim(split, 0)
    send = torch.view_as_real(blocks.contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    got = torch.view_as_complex(recv)  # [n, ..., block of split, ...]
    # rank j's block goes to position j along concat
    return got.movedim(0, concat).flatten(concat, concat + 1)


def _fft2_local(xl: torch.Tensor, group, n: int, inverse: bool) -> torch.Tensor:
    """Local body: H-sharded space [..., H/n, W] -> W-sharded spectrum
    [..., H, W/n] (forward), and back (inverse)."""
    nd = xl.ndim
    if not inverse:
        xl = torch.fft.fft(xl, dim=-1)
        xl = _all_to_all(xl, group, n, split=nd - 1, concat=nd - 2)
        return torch.fft.fft(xl, dim=-2)
    xl = torch.fft.ifft(xl, dim=-2)
    xl = _all_to_all(xl, group, n, split=nd - 2, concat=nd - 1)
    return torch.fft.ifft(xl, dim=-1)


def make_distributed_fft2(mesh, axis: str = "space", ndim: int = 4,
                          batch_axis: Optional[str] = None):
    """Build (fft2, ifft2) over the trailing two dims of ``ndim``-d tensors,
    sharded over ``mesh[axis]``.

    fft2 maps H-sharded real or complex tensors (a DTensor, or a global
    value that each rank slices to its rows) to W-sharded complex64
    DTensor spectra; ifft2 maps back. H and W must divide the axis size.

    ``batch_axis``: also shard the leading dim over this mesh axis
    (composite batch x space on a 2-D mesh). The all-to-all still runs
    only over ``axis`` sub-groups.

    ``fft2.local`` / ``ifft2.local`` are the same transforms on this rank's
    plain block (a caller that keeps its spectrum as a local slab).
    """
    if batch_axis is not None and ndim < 3:
        raise ValueError("batch_axis needs ndim >= 3 (leading batch dim)")
    lead = {batch_axis: 0} if batch_axis else {}
    row = {**lead, axis: ndim - 2}
    col = {**lead, axis: ndim - 1}
    group, n = mesh.get_group(axis), axis_size(mesh, axis)

    def local(xl, inverse):
        check_device(xl, mesh)
        return _fft2_local(xl.to(torch.complex64), group, n, inverse)

    def fft2(x):
        return from_local(local(local_shard(x, mesh, row), False), mesh, col)

    def ifft2(x):
        return from_local(local(local_shard(x, mesh, col), True), mesh, row)

    fft2.local = lambda xl: local(xl, False)
    ifft2.local = lambda xl: local(xl, True)
    return fft2, ifft2

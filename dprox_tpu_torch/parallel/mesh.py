"""Device meshes and DTensor placements for sharded solving.

Counterpart of dprox_tpu/parallel/mesh.py. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, its axes named; a sharded array is a ``DTensor``, the
counterpart of a ``jax.Array`` with a ``NamedSharding``: ``Shard(d)`` on
the mesh axis that splits tensor dim d, ``Replicate()`` on every other.

Collectives run on the mesh's device: NCCL over CUDA tensors, gloo over
CPU tensors. A CUDA mesh over a gloo group raises, so CUDA collectives
never route through the host.

The sharded functions of this package (``parallel.fft``,
``parallel.spatial``, ``parallel.consensus``, ``parallel.dcg``) take a
DTensor or a plain tensor (a global value, the same on every rank) and
compute on plain local shards (``local_shard``) with explicit
collectives on ``mesh.get_group(axis)``; their outputs are wrapped back
into DTensors (``from_local``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def _start_world(device_type: str):
    """Join or start the default process group: a launcher's (``RANK`` /
    ``WORLD_SIZE`` in the environment, rendezvous ``env://``), else a
    one-rank world on a ``HashStore``. NCCL for a CUDA mesh, gloo for a
    CPU mesh."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; pass device_type='cpu'")
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, which this torch build lacks")
    if "RANK" in os.environ or "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _check_backend(device_type: str):
    backend = dist.get_backend()
    need = "nccl" if device_type == "cuda" else "gloo"
    if need not in backend:
        raise RuntimeError(
            f"a {device_type} mesh needs a {need} process group, got {backend!r}: "
            f"collectives on {device_type} tensors would not run on the {device_type}")


def create_mesh(axis_names: Sequence[str] = ("batch",),
                shape: Optional[Sequence[int]] = None, devices=None,
                device_type: str = "cuda") -> DeviceMesh:
    """Build a mesh over every rank of the world (or over the ranks in
    ``devices``), starting a one-rank world first when no process group
    exists and no launcher set ``RANK`` / ``WORLD_SIZE``.

    With one axis the mesh is 1-D over every rank; multi-axis shapes must
    multiply to the rank count. Every rank calls it with the same
    arguments.
    """
    axis_names = tuple(axis_names)
    if not dist.is_initialized():
        _start_world(device_type)
    _check_backend(device_type)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(ranks),)
    if devices is None:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axis_names)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=axis_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def placements(mesh: DeviceMesh, dims: Dict[str, int]):
    """The DTensor placements that shard tensor dim ``dims[a]`` over each
    mesh axis ``a`` named there and replicate over the others."""
    unknown = set(dims) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} not in {mesh.mesh_dim_names}")
    return [Shard(dims[a]) if a in dims else Replicate() for a in mesh.mesh_dim_names]


def local_shard(x, mesh: DeviceMesh, dims: Dict[str, int]) -> torch.Tensor:
    """This rank's block of ``x`` under ``placements(mesh, dims)``, as a
    plain tensor. A DTensor already placed so gives its local tensor; a
    replicated one, or a plain tensor (a global value, the same on every
    rank), is sliced here with no communication; any other DTensor is
    redistributed. Each sharded dim must divide its mesh axis."""
    target = placements(mesh, dims)
    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(target):
            return x.to_local()
        if any(not p.is_replicate() for p in x.placements):
            return x.redistribute(mesh, target).to_local()
        x = x.to_local()
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    coord = mesh.get_coordinate()
    for i, a in enumerate(mesh.mesh_dim_names):
        if a not in dims:
            continue
        d, n = dims[a], mesh.size(i)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} not divisible by mesh axis "
                             f"{a!r} of size {n}")
        step = x.shape[d] // n
        x = x.narrow(d, coord[i] * step, step)
    return x


def check_device(t: torch.Tensor, mesh: DeviceMesh):
    """Collectives run on the mesh's device: a tensor elsewhere raises (a
    gloo group would carry a CUDA tensor through the host)."""
    if t.device.type != mesh.device_type:
        raise ValueError(f"a {t.device.type} tensor on a {mesh.device_type} mesh; move it "
                         f"to the mesh's device first")


def local_operand(t, mesh: DeviceMesh, dims: Dict[str, int], ndim: int):
    """This rank's block of an operand that broadcasts against ``ndim``-d
    tensors placed by ``dims`` (its dims aligned from the right; a dim of
    size 1 is not sliced); a scalar as it is."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if not isinstance(t, torch.Tensor) or t.ndim == 0:
        return t
    coord = mesh.get_coordinate()
    for i, a in enumerate(mesh.mesh_dim_names):
        d = dims[a] - ndim + t.ndim if a in dims else -1
        if d < 0 or t.shape[d] == 1:
            continue
        n = mesh.size(i)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of size {t.shape[d]} not divisible by mesh axis "
                             f"{a!r} of size {n}")
        step = t.shape[d] // n
        t = t.narrow(d, coord[i] * step, step)
    return t


def from_local(local: torch.Tensor, mesh: DeviceMesh, dims: Dict[str, int]) -> DTensor:
    """Wrap this rank's block (``local_shard``'s layout, every block the
    same shape) as a DTensor, with no communication."""
    shape = list(local.shape)
    for i, a in enumerate(mesh.mesh_dim_names):
        if a in dims:
            shape[dims[a]] *= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(mesh, dims), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def map_local(fn, *ts):
    """``fn`` on the local blocks of DTensors (each redistributed like the
    first, which is free when they are placed alike), its outputs (a
    tensor or a tuple) wrapped back like the first: for the ops DTensor
    lacks, such as the ctypes kernels."""
    ref = ts[0]
    mesh, place = ref.device_mesh, ref.placements
    out = fn(*(t.redistribute(mesh, place).to_local() for t in ts))

    def wrap(o):
        return DTensor.from_local(o, mesh, place, run_check=False, shape=ref.shape,
                                  stride=ref.stride())

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def to_global(x) -> torch.Tensor:
    """The whole value of ``x`` on every rank: a DTensor's ``full_tensor``
    (a collective), a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def batch_sharding(mesh: DeviceMesh, axis: str = "batch"):
    """Placements that shard the leading (batch) dim of BCHW tensors over
    ``axis``."""
    return placements(mesh, {axis: 0})


def shard_batch(x, mesh: DeviceMesh, axis: str = "batch") -> DTensor:
    """A batched tensor (the same on every rank) with its batch dim sharded
    over ``axis``, on the mesh's device."""
    x = torch.as_tensor(x).to(_mesh_device(mesh))
    return from_local(local_shard(x, mesh, {axis: 0}), mesh, {axis: 0})


def replicate(x, mesh: DeviceMesh) -> DTensor:
    x = torch.as_tensor(x).to(_mesh_device(mesh))
    return from_local(x, mesh, {})


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)

"""Device resolution, tensor conversion and batching conventions.

Counterpart of dprox_tpu/utils/misc.py. The canonical layout is BCHW
float32: HWC images are permuted to CHW and batched; ``debatchify``
reverses the transform.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA without a GPU raises
    (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


class _TaggedArray(np.ndarray):
    """A numpy array tagged as already batched (``array``)."""

    is_dp_array = True


def array(x) -> np.ndarray:
    """Tag an array as already batched, so ``to_tensor(batch=True)`` takes
    it as it is (the JAX package's ``dp.utils.array``)."""
    return np.asarray(x).view(_TaggedArray)


def to_tensor(x, batch: bool = False, device=None) -> torch.Tensor:
    """Convert to a float/complex tensor, optionally adding batch dims.

    HWC (C in {1,3}) -> CHW; then one leading axis if ndim < 4, as
    dprox_tpu/utils/misc.py::to_jax_array adds it (a 2-D matrix becomes
    [1, H, W], which ``Algorithm._restore_shape`` undoes); an ``array``
    is taken as it is. ``device=None`` keeps a tensor where it is and puts
    numpy data on the CPU.
    """
    tagged = getattr(x, "is_dp_array", False)
    out = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if device is not None:
        out = out.to(device)
    if batch and not tagged:
        if out.ndim == 3 and out.shape[2] in (1, 3):
            out = out.permute(2, 0, 1)
        if out.ndim < 4:
            out = out[None]
    return out


def debatchify(out: np.ndarray, squeeze: bool = False) -> np.ndarray:
    """BCHW -> CHW -> HWC -> HW depending on shape/squeeze."""
    if out.ndim == 4:
        out = out[0]
    if out.ndim == 3:
        if out.shape[0] in (1, 3):
            out = out.transpose(1, 2, 0)
        if out.shape[2] == 1 and squeeze:
            out = out[..., 0]
    return out


def to_ndarray(x, debatch: bool = False, squeeze: bool = False) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            raise TypeError("to_ndarray received a complex tensor; take "
                            ".real explicitly")
        out = x.detach().cpu().numpy()
    else:
        out = np.asarray(x)
        if np.iscomplexobj(out):
            raise TypeError("to_ndarray received a complex array; take "
                            ".real explicitly")
        out = out.astype(np.float32, copy=False)
    if debatch:
        out = debatchify(out, squeeze)
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (a sharded
    array, ``dprox_tpu_torch.parallel``), without importing that module:
    no DTensor exists until something has imported it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def safe_sqrt(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return torch.sqrt(torch.maximum(x, x.new_full((), eps)))  # filled on the device


def expand_to_bchw(r: torch.Tensor) -> torch.Tensor:
    """[B] -> [B,1,1,1] for broadcasting against BCHW images."""
    if r.ndim == 1:
        return r.reshape(r.shape[0], 1, 1, 1)
    return r


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's generators (every device's);
    returns torch's default generator, where the JAX package returns a
    key."""
    import random

    np.random.seed(seed)
    random.seed(seed)
    return torch.manual_seed(seed)


def outlier_correct(arr: np.ndarray, p: float = 0.01) -> np.ndarray:
    """Clip ``arr`` to its [p, 100 - p] percentiles."""
    lo, hi = np.percentile(arr, [p, 100 - p])
    return np.clip(arr, lo, hi)


def crop_center_region(arr: np.ndarray, size: int = 150) -> np.ndarray:
    """The central ``size`` x ``size`` region of an [H, W, ...] array."""
    h, w = arr.shape[:2]
    r0 = (h - size) // 2
    c0 = (w - size) // 2
    return arr[r0:r0 + size, c0:c0 + size]

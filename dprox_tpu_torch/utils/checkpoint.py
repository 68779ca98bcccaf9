"""Read flax msgpack checkpoints without flax or msgpack.

The shipped ``weights/*.msgpack`` files were written by
``flax.serialization.to_bytes``. This module decodes the subset of
msgpack those files use (maps, strings, binary, arrays, ints, floats,
nil, bool) plus flax's extension type 1 (ndarray), whose payload is
itself a msgpack triple ``(shape, dtype_name, raw_bytes)``. The
converters below carry the JAX package's flax params (from a msgpack, or
as numpy arrays) into the port's modules: FFDNet, the RL tuner's networks
and a trained DEQ's params.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F, raw)
        if 0x90 <= t <= 0x9F:
            return [self.obj(raw) for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F, raw)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack("BHI"[t - 0xC4]))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack("BHI"[t - 0xC7])
            return self.ext(self.unpack("b"), self.take(n))
        if t == 0xCA:
            return self.unpack("f")
        if t == 0xCB:
            return self.unpack("d")
        if 0xCC <= t <= 0xCF:
            return self.unpack("BHIQ"[t - 0xCC])
        if 0xD0 <= t <= 0xD3:
            return self.unpack("bhiq"[t - 0xD0])
        if 0xD4 <= t <= 0xD8:
            code = self.unpack("b")
            return self.ext(code, self.take(1 << (t - 0xD4)))
        if 0xD9 <= t <= 0xDB:
            return self.str(self.unpack("BHI"[t - 0xD9]), raw)
        if t in (0xDC, 0xDD):
            return [self.obj(raw) for _ in range(self.unpack("HI"[t - 0xDC]))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack("HI"[t - 0xDE]), raw)
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def str(self, n: int, raw: bool):
        data = self.take(n)
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    @staticmethod
    def ext(code: int, data: bytes):
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, raw = _Reader(data).obj(raw=True)
        return np.frombuffer(raw, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays that
    ``flax.serialization.msgpack_restore`` returns for ``path``."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def ffdnet_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """FFDNet params (``params/Conv_i/Conv_0/{kernel,bias}``, HWIO) ->
    ``models.ffdnet.FFDNet`` state dict (``convs.i.{weight,bias}``, OIHW),
    for any in_nc (gray nets have in_nc = 1: 4 + 1 input channels).

    ``tree`` is what ``load_flax_msgpack`` returns, or the JAX package's
    params as numpy arrays (``jax.tree.map(np.asarray, params)``); each
    leaf is copied, so the state dict shares no memory with ``tree``."""
    params = tree["params"]
    sd = {}
    for i in range(len(params)):
        layer = params[f"Conv_{i}"]["Conv_0"]
        kernel = np.asarray(layer["kernel"], np.float32)
        sd[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return sd


def convnet_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The RL tuner's flax ``ResNetPolicy`` / ``CriticNet`` params ->
    ``algo/special/rl.py``'s module state dict. flax names layers by
    creation order: ``Conv_0`` (the stride-2 stem), ``Conv_1`` ... (two a
    residual block), ``Dense_0`` ... (the policy's hidden layer, rho,
    sigmas and stop; the critic's three); they become ``convs.i`` (HWIO ->
    OIHW) and ``dense.j`` (the [in, out] kernel transposed)."""
    sd = {}
    for name, layer in tree["params"].items():
        kind, index = name.split("_")
        kernel = np.asarray(layer["kernel"], np.float32)
        prefix = {"Conv": "convs", "Dense": "dense"}[kind]
        weight = kernel.transpose(3, 2, 0, 1) if kind == "Conv" else kernel.T
        sd[f"{prefix}.{index}.weight"] = torch.from_numpy(np.array(weight, order="C"))
        sd[f"{prefix}.{index}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return sd


def deq_params_from_flax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A trained DEQ's params (``weights/deq_*.msgpack``, or the JAX
    package's ``{deq_r, deq_l, deq_prior}`` as numpy arrays) -> the port's
    ``params``: ``deq_r`` and ``deq_l`` as float32 scalars, ``deq_prior``
    through ``ffdnet_state_dict_from_flax``."""
    return {"deq_r": torch.tensor(np.float32(tree["deq_r"])),
            "deq_l": torch.tensor(np.float32(tree["deq_l"])),
            "deq_prior": ffdnet_state_dict_from_flax(tree["deq_prior"])}

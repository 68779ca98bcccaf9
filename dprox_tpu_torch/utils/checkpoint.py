"""Read and write flax msgpack checkpoints without flax or msgpack.

The shipped ``weights/*.msgpack`` files were written by
``flax.serialization.to_bytes``. This module decodes the subset of
msgpack those files use (maps, strings, binary, arrays, ints, floats,
nil, bool) plus flax's extension types 1 (ndarray), whose payload is
itself a msgpack triple ``(shape, dtype_name, raw_bytes)``, 2 (a Python
complex) and 3 (a numpy scalar); ``save_pytree`` writes the same format,
so the JAX package's ``load_pytree`` reads what the port saves. The
converters below carry the JAX package's flax params (from a msgpack, or
as numpy arrays) into the port's modules: FFDNet (and FFDNet3D), the RL
tuner's networks, a trained DEQ's params, and the zoo: UNetRes, the conv
stacks (DnCNN, IRCNN's 25 weight sets), UNet, OpticsUNet, GRUnet and
QRNNREDC3D, DGUDenoiser and the derain LearnableDegOp. Kernels go from
HWIO to OIHW (3-D: DHWIO to OIDHW); a flax ``nn.ConvTranspose`` kernel
(HWIO, ``transpose_kernel=False``) becomes torch's true-adjoint
``ConvTranspose2d`` weight with its taps flipped and in/out swapped.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


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
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).obj()
            return complex(re, im)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, raw = _Reader(data).obj(raw=True)
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def _pack(obj, out: bytearray) -> None:
    """Append the msgpack encoding of ``obj`` (a nested dict with str keys
    of arrays, tensors and Python scalars) to ``out``, as flax's
    ``msgpack_serialize`` writes it."""
    def sized(n, tags):  # the first (tag, length format) that holds n
        for tag, fmt in tags:
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.extend(struct.pack(">B" + fmt, tag, n))
                return
        raise ValueError(f"msgpack object of size {n} is too large")

    def ext(code, payload):
        if len(payload) in (1, 2, 4, 8, 16):
            out.append(0xD4 + len(payload).bit_length() - 1)
        else:
            sized(len(payload), ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")))
        out.extend(struct.pack(">b", code))
        out.extend(payload)

    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        payload = bytearray()
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], payload)
        ext(_EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR, payload)
    elif isinstance(obj, dict):
        if len(obj) <= 15:
            out.append(0x80 | len(obj))
        else:
            sized(len(obj), ((0xDE, "H"), (0xDF, "I")))
        for k, v in obj.items():
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        if len(obj) <= 15:
            out.append(0x90 | len(obj))
        else:
            sized(len(obj), ((0xDC, "H"), (0xDD, "I")))
        for v in obj:
            _pack(v, out)
    elif obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):  # the shortest form, as msgpack writes it
        if -32 <= obj <= 0x7F:
            out.extend(struct.pack(">b" if obj < 0 else ">B", obj))
        else:
            fmts = "BHIQ" if obj > 0 else "bhiq"
            for i, fmt in enumerate(fmts):
                lo, hi = (0, 1 << (8 << i)) if obj > 0 else (-(1 << ((8 << i) - 1)), 0)
                if lo <= obj < hi:
                    out.extend(struct.pack(">B" + fmt, (0xCC if obj > 0 else 0xD0) + i, obj))
                    break
            else:
                raise ValueError(f"integer {obj} does not fit in 64 bits")
    elif isinstance(obj, float):
        out.extend(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, complex):
        payload = bytearray()
        _pack([obj.real, obj.imag], payload)
        ext(_EXT_COMPLEX, payload)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        if len(data) <= 31:
            out.append(0xA0 | len(data))
        else:
            sized(len(data), ((0xD9, "B"), (0xDA, "H"), (0xDB, "I")))
        out.extend(data)
    elif isinstance(obj, (bytes, bytearray)):
        sized(len(obj), ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")))
        out.extend(obj)
    else:
        raise TypeError(f"cannot serialise a {type(obj).__name__}")


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays that
    ``flax.serialization.msgpack_restore`` returns for ``path``."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def _state_dict(tree):
    """flax's state dict of ``tree``: lists and tuples become dicts keyed
    "0", "1", ..."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_pytree(path: str, tree: Any) -> str:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, arrays
    and Python scalars) to ``path`` in flax's msgpack format, which
    ``load_pytree`` and the JAX package's ``load_pytree`` (without orbax)
    read; returns "msgpack"."""
    out = bytearray()
    _pack(_state_dict(tree), out)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)
    return "msgpack"


def _restore(template, state):
    if template is None:
        if isinstance(state, dict):
            return {k: _restore(None, v) for k, v in state.items()}
        return torch.from_numpy(state) if isinstance(state, np.ndarray) else state
    if isinstance(template, dict):
        return {k: _restore(v, state[str(k)]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(v, state[str(i)]) for i, v in enumerate(template))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(state)).to(template.device, template.dtype)
    return state


def load_pytree(path: str, template: Any = None):
    """Read a flax msgpack file (``save_pytree``'s, or the JAX package's
    msgpack ``save_pytree``). Without ``template``: nested dicts of
    tensors; with one: its structure, each tensor leaf on its device and
    in its dtype."""
    return _restore(template, load_flax_msgpack(path))


def doe_params_from_flax(tree: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """The DOE co-design params (``weights/doe_codesign.msgpack``, as
    ``load_flax_msgpack`` returns it, or the JAX package's params as numpy
    arrays) -> {"height_map_sqrt": [1, 1, R, R], "rhos": [T], "sigmas":
    [T]} float32 tensors on ``device``, by name."""
    return {k: torch.as_tensor(np.asarray(tree[k], np.float32)).to(device)
            for k in ("height_map_sqrt", "rhos", "sigmas")}


def load_doe_codesign(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """``doe_params_from_flax`` of the msgpack file at ``path``."""
    return doe_params_from_flax(load_flax_msgpack(path), device)


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def conv_weight_from_flax(kernel, spatial: int = 2) -> torch.Tensor:
    """flax conv kernel (``spatial`` kernel axes, then in, out; leading
    stack axes kept) -> torch (out, in, kernel axes): HWIO -> OIHW, DHWIO
    -> OIDHW."""
    k = np.asarray(kernel, np.float32)
    lead = k.ndim - spatial - 2
    order = list(range(lead)) + [k.ndim - 1, k.ndim - 2] + list(range(lead, lead + spatial))
    return _t(k.transpose(order))


def convt_weight_from_flax(kernel) -> torch.Tensor:
    """flax ``nn.ConvTranspose`` kernel (H, W, in, out) -> torch
    ``ConvTranspose2d`` weight (in, out, H, W) with the taps flipped."""
    k = np.asarray(kernel, np.float32)
    return _t(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def _conv_into(sd, prefix, layer, transposed=False, spatial=2):
    if transposed:
        sd[prefix + "weight"] = convt_weight_from_flax(layer["kernel"])
    else:
        sd[prefix + "weight"] = conv_weight_from_flax(layer["kernel"], spatial)
    if "bias" in layer:
        sd[prefix + "bias"] = _t(layer["bias"])


def unetres_state_dict_from_flax(tree: Dict[str, Any], nb: int) -> Dict[str, torch.Tensor]:
    """DRUNet ``UNetRes`` params (``Conv_0`` head, ``ResBlock_k`` in
    creation order, ``DownStrideConv_i``, ``UpTransposeConv_i``, ``Conv_1``
    tail) -> ``models.drunet.UNetRes`` state dict (the reference's names)."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    _conv_into(sd, "m_head.", p["Conv_0"]["Conv_0"])
    _conv_into(sd, "m_tail.", p["Conv_1"]["Conv_0"])

    def res(prefix, k):
        for j, name in ((0, "Conv_0"), (2, "Conv_1")):
            _conv_into(sd, f"{prefix}.res.{j}.", p[f"ResBlock_{k}"][name]["Conv_0"])

    for s in range(3):
        for j in range(nb):
            res(f"m_down{s + 1}.{j}", s * nb + j)
        _conv_into(sd, f"m_down{s + 1}.{nb}.", p[f"DownStrideConv_{s}"]["Conv_0"])
    for j in range(nb):
        res(f"m_body.{j}", 3 * nb + j)
    for i, s in enumerate((3, 2, 1)):
        _conv_into(sd, f"m_up{s}.0.", p[f"UpTransposeConv_{i}"]["ConvTranspose_0"],
                   transposed=True)
        for j in range(nb):
            res(f"m_up{s}.{1 + j}", (4 + i) * nb + j)
    return sd


def conv_stack_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """DnCNN / FDnCNN / IRCNN params (``Conv_i/Conv_0``) -> the ``model``
    stack of ``models/dncnn.py`` (conv i at ``model.{2i}``). A leading
    stack axis (IRCNN's 25 weight sets) is kept."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(p)):
        _conv_into(sd, f"model.{2 * i}.", p[f"Conv_{i}"]["Conv_0"])
    return sd


def unet_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """UNet params (``ConvBlock_0..4`` down, ``5..8`` up, ``Conv_0`` out)
    -> ``models.unet.UNet`` state dict."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for b in range(9):
        prefix = f"down.{b}" if b < 5 else f"up.{b - 5}"
        for j in range(3):
            _conv_into(sd, f"{prefix}.{j}.", p[f"ConvBlock_{b}"][f"Conv_{j}"]["Conv_0"])
    _conv_into(sd, "out.", p["Conv_0"])
    return sd


def optics_unet_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """OpticsUNet params -> ``models.optics_unet.OpticsUNet`` state dict."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for b in range(9):
        prefix = f"enc.{b}" if b < 5 else f"dec.{b - 5}"
        for j, name in enumerate(("conv1", "conv2", "shortcut")):
            _conv_into(sd, f"{prefix}.{name}.", p[f"OpticsConvBlock_{b}"][f"Conv_{j}"])
    for i in range(4):
        _conv_into(sd, f"down.{i}.", p[f"Conv_{i}"])
        _conv_into(sd, f"up.{i}.", p[f"ConvTranspose_{i}"], transposed=True)
    _conv_into(sd, "out.", p["Conv_4"])
    return sd


def _qrnn_layer_into(sd, prefix, node):
    """A flax QRNNConv3D / BiQRNNConv3D subtree -> ``prefix.conv.*``."""
    wrapper = node.get("UpsampleConv3d_0")
    if wrapper is not None:
        conv = wrapper["Conv3d_0"]["Conv_0"]
    else:
        wrapper = node["Conv3d_0"]
        conv = wrapper["Conv_0"]
    _conv_into(sd, prefix + ".conv.conv.", conv, spatial=3)
    if "bn_scale" in wrapper:
        sd[prefix + ".conv.bn_scale"] = _t(wrapper["bn_scale"])
        sd[prefix + ".conv.bn_shift"] = _t(wrapper["bn_shift"])


def grunet_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """GRUnet params (flax creation order: ``BiQRNNConv3D_0``, then
    ``QRNNConv3D_i`` / ``ConvBlock_i`` alternating down and up,
    ``BiQRNNConv3D_1``) -> ``models.qrnn.GRUnet`` state dict."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    names = ["Down1", "Down2", "Down3", "Down4", "Up5", "Up4", "Up3", "Up2"]
    blocks = ["Conv2", "Conv3", "Conv4", "Conv5", "Up_conv5", "Up_conv4", "Up_conv3", "Up_conv2"]
    _qrnn_layer_into(sd, "Conv1", p["BiQRNNConv3D_0"])
    _qrnn_layer_into(sd, "Conv", p["BiQRNNConv3D_1"])
    for i, (layer, block) in enumerate(zip(names, blocks)):
        _qrnn_layer_into(sd, layer, p[f"QRNNConv3D_{i}"])
        for j, sub in enumerate(("conv1", "conv2", "shortcut")):
            _qrnn_layer_into(sd, f"{block}.{sub}", p[f"ConvBlock_{i}"][f"QRNNConv3D_{j}"])
    return sd


def qrnn3d_state_dict_from_flax(tree: Dict[str, Any], num_half_layer: int = 5
                                ) -> Dict[str, torch.Tensor]:
    """QRNNREDC3D params (``BiQRNNConv3D_0`` features, ``QRNNConv3D_i``
    encoder then decoder, ``BiQRNNConv3D_1`` reconstructor) ->
    ``models.qrnn.QRNNREDC3D`` state dict."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    _qrnn_layer_into(sd, "feature_extractor", p["BiQRNNConv3D_0"])
    _qrnn_layer_into(sd, "reconstructor", p["BiQRNNConv3D_1"])
    for i in range(2 * num_half_layer):
        part = "encoder" if i < num_half_layer else "decoder"
        _qrnn_layer_into(sd, f"{part}.{i % num_half_layer}", p[f"QRNNConv3D_{i}"])
    return sd


# the reference DGUNet's torch prefixes -> flax top-level names
# (dprox_tpu/models/dgu.py::_DGU_TOP)
_DGU_TOP = {
    "shallow_feat1.0": "shallow1_0", "shallow_feat1.1": "shallow1_1",
    "stage1_encoder": "enc1", "stage1_decoder": "dec1", "sam12": "sam12",
    "basic.shallow_feat2.0": "shallow2_0", "basic.shallow_feat2.1": "shallow2_1",
    "basic.merge12": "merge12", "basic.stage2_encoder": "enc2",
    "basic.stage2_decoder": "dec2", "basic.sam23": "sam23",
    "shallow_feat7.0": "shallow7_0", "shallow_feat7.1": "shallow7_1",
    "concat67": "concat67", "tail": "tail",
}


def dgu_flax_path(key: str) -> Optional[Tuple[str, ...]]:
    """The flax param path of a reference-named DGUNet state-dict key (the
    rewrite of dprox_tpu/models/dgu.py::_dgu_rewrite_key), or None for a
    key with no flax counterpart."""
    for prefix, top in _DGU_TOP.items():
        if key.startswith(prefix + "."):
            rest = key[len(prefix) + 1:]
            break
    else:
        return None
    if rest == "body.1.weight":  # CAB's PReLU
        return (top, "prelu", "alpha")
    parts = rest.split(".")
    out, i = [top], 0
    while i < len(parts) - 1:
        p = parts[i]
        if p in ("body", "skip_conv") and parts[i + 1].isdigit():
            if i + 2 < len(parts) and parts[i + 2] in ("up", "conv_block"):
                out.append(f"{parts[i + 2]}_{parts[i + 1]}")
                i += 3
            else:
                out.append(f"{p}_{parts[i + 1]}")
                i += 2
        elif p == "conv_du" and parts[i + 1].isdigit():
            out.append(f"conv_du_{parts[i + 1]}")
            i += 2
        elif p == "norm":
            return tuple(out) + ({"weight": "in_gamma", "bias": "in_beta"}[parts[i + 1]],)
        else:
            out.append(p)
            i += 1
    return tuple(out) + ({"weight": "kernel", "bias": "bias"}[parts[-1]],)


def dgu_state_dict_from_flax(tree: Dict[str, Any], keys: Iterable[str]
                             ) -> Dict[str, torch.Tensor]:
    """DGUDenoiser params -> the state dict of ``models.dgu.DGUDenoiser``
    for its ``keys`` (``module.state_dict().keys()``), each read at its
    flax path (``dgu_flax_path``)."""
    root = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for key in keys:
        path = dgu_flax_path(key)
        node = root
        for name in path:
            node = node[name]
        if path[-1] != "kernel":
            sd[key] = _t(node)
        elif path[-2].startswith("up_"):
            sd[key] = convt_weight_from_flax(node)
        else:
            sd[key] = conv_weight_from_flax(node)
    return sd


def deg_op_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The derain ``LearnableDegOp`` params ({name: {params: {Conv_0,
    PReLU_0, Conv_1}}}) -> {name: ``contrib.derain.ResBlock`` state dict}."""
    out = {}
    for name, sub in tree.items():
        p = sub["params"]
        sd: Dict[str, torch.Tensor] = {}
        _conv_into(sd, "body.0.", p["Conv_0"])
        sd["body.1.weight"] = _t(p["PReLU_0"]["alpha"])
        _conv_into(sd, "body.2.", p["Conv_1"])
        out[name] = sd
    return out

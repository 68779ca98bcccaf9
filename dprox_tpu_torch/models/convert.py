"""Torch checkpoints of the reference's zoo into the port's modules.

Counterpart of dprox_tpu/models/convert.py. The JAX package converts a
torch state dict into flax params; here the modules are torch modules, so
the conversion is a passthrough: where a module carries the reference's
attribute names (UNetRes, the conv stacks, DGUDenoiser) the state dict
loads as it is, after ``fold_batchnorm`` where the JAX package folds
(DnCNN 'BR' checkpoints). ``positional_state_dict`` maps the convs of an
ordered reference state dict one for one onto a module's convs (the
FFDNet3D and UNet checkpoints, whose names the port does not share), and
``qrnn_state_dict`` handles the QRNN3D / GRUNet checkpoints' quirks as
the JAX package's ``qrnn_torch_to_flax`` does: the pre-conv BatchNorm
becomes the explicit (bn_scale, bn_shift) affine, the decoder's stride-1
ConvTranspose3d kernels are flipped and transposed into plain convs, and
GRUnet's registration order is put into call order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

# torch GRUnet registers Down1..4 before Conv1..5 but calls them
# interleaved; the port's GRUnet registers them in call order
GRUNET_FORWARD_ORDER = (
    "Conv1", "Down1", "Conv2", "Down2", "Conv3", "Down3", "Conv4", "Down4",
    "Conv5", "Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3",
    "Up2", "Up_conv2", "Conv")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load(path, map_location="cpu")``, unwrapped from a
    ``state_dict`` / ``net`` entry or a pickled module."""
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, nn.Module):
        sd = sd.state_dict()
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "net" in sd:
        sd = sd["net"]
    return dict(sd)


def fold_batchnorm(sd: Dict[str, torch.Tensor], bn_eps: float = 1e-4) -> Dict[str, torch.Tensor]:
    """Fold conv -> BN pairs into the conv (keys in registration order).
    ``bn_eps`` 1e-4: the reference's KAIR BatchNorm2d layers use it."""
    keys = list(sd)
    out = dict(sd)
    for i, k in enumerate(keys):
        if not k.endswith("running_mean"):
            continue
        prefix = k[: -len("running_mean")]
        mean, var = sd[prefix + "running_mean"], sd[prefix + "running_var"]
        gamma = sd.get(prefix + "weight", torch.ones_like(mean))
        beta = sd.get(prefix + "bias", torch.zeros_like(mean))
        conv = next((keys[j] for j in range(i - 1, -1, -1)
                     if keys[j].endswith("weight") and sd[keys[j]].ndim == 4), None)
        if conv is None:
            continue
        scale = gamma / torch.sqrt(var + bn_eps)
        bias_key = conv[: -len("weight")] + "bias"
        out[conv] = sd[conv] * scale[:, None, None, None]
        out[bias_key] = (sd.get(bias_key, torch.zeros_like(mean)) - mean) * scale + beta
        for suffix in ("running_mean", "running_var", "weight", "bias", "num_batches_tracked"):
            out.pop(prefix + suffix, None)
    return out


def _convs(module: nn.Module):
    """(weight name, bias name or None) of every conv of ``module`` in
    registration order."""
    out = []
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            pre = f"{name}." if name else ""
            out.append((pre + "weight", pre + "bias" if m.bias is not None else None))
    return out


def positional_state_dict(sd: Dict[str, torch.Tensor], module: nn.Module,
                          bn_eps: float = 1e-4) -> Dict[str, torch.Tensor]:
    """The convs of ``sd`` (BNs folded) in order onto ``module``'s convs in
    registration order; fails on a count or shape mismatch."""
    sd = fold_batchnorm(sd, bn_eps)
    src = [(k, k[: -len("weight")] + "bias") for k in sd
           if k.endswith("weight") and sd[k].ndim in (4, 5)]
    dst = _convs(module)
    if len(src) != len(dst):
        raise ValueError(f"checkpoint has {len(src)} convs, the module {len(dst)}")
    ref = module.state_dict()
    out = {}
    for (w, b), (mw, mb) in zip(src, dst):
        if sd[w].shape != ref[mw].shape:
            raise ValueError(f"{w} {tuple(sd[w].shape)} -> {mw} {tuple(ref[mw].shape)}")
        out[mw] = sd[w]
        if mb is not None and b in sd:
            out[mb] = sd[b]
    return out


def qrnn_state_dict(sd: Dict[str, torch.Tensor], module: nn.Module,
                    prefix_order: Optional[Sequence[str]] = None,
                    bn_eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """A reference QRNN3D / GRUNet checkpoint onto ``module``
    (``models.qrnn.GRUnet`` or ``QRNNREDC3D``): 3-D convs in order, each
    pre-conv BatchNorm3d as ``bn_scale`` / ``bn_shift`` of the conv after
    it, ``deconv`` kernels (stride-1 ConvTranspose3d) flipped and
    transposed; ``prefix_order`` re-buckets the keys by top-level module
    (``GRUNET_FORWARD_ORDER``)."""
    if prefix_order:
        rank = {p: i for i, p in enumerate(prefix_order)}
        sd = dict(sorted(sd.items(), key=lambda kv: rank.get(kv[0].split(".")[0],
                                                             len(rank))))
    entries, pending = [], None
    for k, v in sd.items():
        if k.endswith("running_mean"):
            pre = k[: -len("running_mean")]
            mean = sd[pre + "running_mean"].double()
            gamma = sd.get(pre + "weight", torch.ones_like(mean)).double()
            beta = sd.get(pre + "bias", torch.zeros_like(mean)).double()
            scale = gamma / torch.sqrt(sd[pre + "running_var"].double() + bn_eps)
            pending = (scale.float(), (beta - mean * scale).float())
        elif k.endswith("weight") and v.ndim == 5:
            w = v.flip(2, 3, 4).transpose(0, 1) if "deconv" in k else v
            entries.append((w, sd.get(k[: -len("weight")] + "bias"), pending))
            pending = None
    dst = [(name[: -len("conv.weight")], name, b) for name, b in _convs(module)]
    if len(entries) != len(dst):
        raise ValueError(f"checkpoint has {len(entries)} 3-D convs, the module {len(dst)}")
    ref = module.state_dict()
    out = {}
    for (w, b, bn), (holder, mw, mb) in zip(entries, dst):
        if w.shape != ref[mw].shape:
            raise ValueError(f"3-D conv {mw}: {tuple(w.shape)} vs {tuple(ref[mw].shape)}")
        out[mw] = w.contiguous()
        if mb is not None and b is not None:
            out[mb] = b
        if (bn is not None) != (holder + "bn_scale" in ref):
            raise ValueError(f"pre-BN mismatch at {mw} (check the module's bn flag)")
        if bn is not None:
            out[holder + "bn_scale"], out[holder + "bn_shift"] = bn
    return out

"""Denoiser wrappers: a uniform ``denoise(x, sigma)`` on BCHW tensors.

Counterpart of dprox_tpu/proxfn/pnp/denoisers.py: the gray
``FFDNetDenoiser`` (bands folded into the batch by ``Denoiser2D``),
``FFDNetColorDenoiser``, ``FFDNet3DDenoiser``, ``DRUNetDenoiser`` (with
the quadrant split above ``min_size``), ``IRCNNDenoiser`` (25 weight sets,
the set picked on the device), ``UNetDenoiser``, ``TVDenoiser`` (2-D or
3-D), the x8 dihedral self-ensemble ``Augment``, ``BF16Denoiser``,
``EnsembleDenoiser`` and ``DeepTVDenoiser``. The 2-D TV branch always goes
through the fused TV kernel wrapper (ops/kernels.py::tv_denoise_chw),
which launches the CUDA kernel for CUDA tensors and runs its plain version
for CPU ones; 3-D TV couples the bands and runs as plain PyTorch, as the
JAX package runs it outside its kernel. Networks are ``nn.Module``s in
eval mode with frozen parameters; ``denoise(x, sigma, params)`` runs a
network with the weight dict ``params`` in place of its own
(``torch.func.functional_call``), so weights that require grad are
trained through the frozen module, as the JAX package threads its params
pytree.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ...models import IRCNN, FFDNet, FFDNet3D, UNet, UNetRes
from ...models.convert import load_torch_state_dict, positional_state_dict
from ...models.tv import tv_denoising3d_chw
from ...ops.kernels import tv_denoise_chw
from ...utils.checkpoint import (conv_stack_state_dict_from_flax, ffdnet_state_dict_from_flax,
                                 load_flax_msgpack, unet_state_dict_from_flax,
                                 unetres_state_dict_from_flax)


class Denoiser:
    """Base wrapper."""

    #: spatial receptive-field radius in input pixels (None: unknown)
    receptive_radius = None
    #: the weight dict ``denoise(..., params=)`` takes (None: no network)
    params = None

    def to(self, device) -> "Denoiser":
        return self

    def denoise(self, x: torch.Tensor, sigma, params=None) -> torch.Tensor:
        """x: [B,C,H,W]; sigma: tensor holding one noise level or one per
        batch element; ``params``: a network's weight dict (its
        ``state_dict`` names) in place of its own weights."""
        raise NotImplementedError

    def __call__(self, x, sigma, params=None):
        return self.denoise(x, sigma, params)


def denoise_with(denoiser, x, sigma, params=None):
    """``denoiser.denoise``, handing it ``params`` only where given, so a
    caller's own denoiser whose ``denoise`` takes no ``params`` composes
    with the wrappers below and with ``deep_prior``."""
    if params is None:
        return denoiser.denoise(x, sigma)
    return denoiser.denoise(x, sigma, params)


class _NetDenoiser(Denoiser):
    """A frozen network ``self.module`` built by ``build()`` from a fixed
    seed, then loaded from flax-layout ``params`` (a nested dict of arrays,
    as ``flax.serialization.msgpack_restore`` or ``jax.tree.map(np.asarray,
    params)`` gives it) through ``from_flax``, or from a checkpoint: a
    ``.msgpack`` the same way, a torch state dict (``.pth``) through
    ``from_torch(state_dict, module)`` (default: by position,
    ``models/convert.py``). With neither it keeps its seeded weights."""

    def _setup(self, build, params, ckpt_path, from_flax, from_torch=positional_state_dict):
        sd = None
        if params is None and ckpt_path is not None:
            if str(ckpt_path).endswith(".msgpack"):
                params = load_flax_msgpack(ckpt_path)
            else:
                sd = load_torch_state_dict(ckpt_path)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.module = build()
        if params is not None:
            self.module.load_state_dict(from_flax(params))
        elif sd is not None:
            self.module.load_state_dict(from_torch(sd, self.module))
        self.module.requires_grad_(False).eval()

    def to(self, device):
        self.module.to(device)
        return self

    @property
    def params(self):
        """The network's weights as a dict of tensors (``state_dict``
        names), the form ``denoise(..., params=)`` takes."""
        return dict(self.module.state_dict())

    def _net(self, params, *args):
        if params is None:
            return self.module(*args)
        return functional_call(self.module, params, args)


def _ffdnet(in_nc, nc, nb, residual):
    return lambda: FFDNet(in_nc=in_nc, out_nc=in_nc, nc=nc, nb=nb, residual=residual)


def _with_sigma_map(x, sigma):
    """x with a last channel holding sigma (one value or one per batch
    element)."""
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1, 1, 1, 1)
    return torch.cat([x, torch.ones_like(x[:, :1]) * sigma], dim=1)


class Denoiser2D(Denoiser):
    """Grayscale model applied per band, the bands folded into the batch."""

    def _denoise_gray(self, x, sigma, params=None):
        raise NotImplementedError

    def denoise(self, x, sigma, params=None):
        B, C, H, W = x.shape
        out = self._denoise_gray(x.reshape(B * C, 1, H, W), sigma, params)
        return out.reshape(B, C, H, W)


class FFDNetDenoiser(_NetDenoiser, Denoiser2D):
    """Gray FFDNet (in_nc = 1)."""

    def __init__(self, params=None, ckpt_path: Optional[str] = None,
                 nc: int = 64, nb: int = 15, residual: bool = False):
        self._setup(_ffdnet(1, nc, nb, residual), params, ckpt_path, ffdnet_state_dict_from_flax)
        # nb 3x3 layers at half resolution (pixel-unshuffle sf=2)
        self.receptive_radius = 2 * nb

    def _denoise_gray(self, x, sigma, params=None):
        return self._net(params, x, sigma)


class FFDNetColorDenoiser(_NetDenoiser):
    """Color FFDNet (in_nc = 3)."""

    def __init__(self, params=None, ckpt_path: Optional[str] = None,
                 nc: int = 96, nb: int = 12, residual: bool = False):
        self._setup(_ffdnet(3, nc, nb, residual), params, ckpt_path, ffdnet_state_dict_from_flax)
        self.receptive_radius = 2 * nb

    def denoise(self, x, sigma, params=None):
        return self._net(params, x, sigma)


class FFDNet3DDenoiser(_NetDenoiser):
    """Hyperspectral FFDNet: the sigma map concatenated as the last input
    channel."""

    def __init__(self, params=None, ckpt_path: Optional[str] = None, in_nc: int = 32,
                 out_nc: int = 31):
        self._setup(lambda: FFDNet3D(in_nc=in_nc, out_nc=out_nc, nc=64, nb=15), params,
                    ckpt_path, ffdnet_state_dict_from_flax)

    def denoise(self, x, sigma, params=None):
        return self._net(params, _with_sigma_map(x, sigma))


class DRUNetDenoiser(_NetDenoiser):
    """DRUNet (UNetRes) on [x, sigma map]: edge-padded to a multiple of
    ``modulo``; above ``min_size`` the four quadrants, each with an
    8-pixel shared border, run one after another and are stitched.
    ``residual``: the net predicts the noise (identity as sigma -> 0)."""

    def __init__(self, n_channels: int = 3, params=None, ckpt_path: Optional[str] = None,
                 min_size: int = 256, modulo: int = 16, nc=(64, 128, 256, 512), nb: int = 4,
                 residual: bool = False):
        self.n_channels, self.min_size, self.modulo = n_channels, min_size, modulo
        self.residual = residual
        self._setup(lambda: UNetRes(in_nc=n_channels + 1, out_nc=n_channels, nc=tuple(nc),
                                    nb=nb), params, ckpt_path,
                    lambda tree: unetres_state_dict_from_flax(tree, nb),
                    from_torch=lambda sd, module: sd)

    def _apply(self, x, params):
        h, w = x.shape[-2:]
        ph, pw = (-h) % self.modulo, (-w) % self.modulo
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="replicate")
        out = self._net(params, x)
        if self.residual:
            out = x[:, :out.shape[1]] - out
        return out[..., :h, :w]

    def denoise(self, x, sigma, params=None):
        inp = _with_sigma_map(x, sigma)
        h, w = inp.shape[-2:]
        if max(h, w) <= self.min_size:
            return self._apply(inp, params)
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        quads = [inp[..., :h2 + 8, :w2 + 8], inp[..., :h2 + 8, w - (w2 + 8):],
                 inp[..., h - (h2 + 8):, :w2 + 8], inp[..., h - (h2 + 8):, w - (w2 + 8):]]
        outs = [self._apply(q, params) for q in quads]
        top = torch.cat([outs[0][..., :h2, :w2], outs[1][..., :h2, -(w - w2):]], dim=-1)
        bot = torch.cat([outs[2][..., -(h - h2):, :w2], outs[3][..., -(h - h2):, -(w - w2):]],
                        dim=-1)
        return torch.cat([top, bot], dim=-2)


IRCNN_SETS = 25


class IRCNNDenoiser(_NetDenoiser, Denoiser2D):
    """IRCNN with 25 weight sets, one per noise level band: the set is
    picked from sigma on the device (``torch.index_select`` with a device
    index), so a call reads nothing back to the host. ``params`` / the
    ``params=`` of ``denoise`` are the stacked sets (leading axis 25); a
    reference checkpoint is a dict of 25 state dicts keyed '0'..'24'."""

    def __init__(self, n_channels: int = 1, params_stack=None, ckpt_path: Optional[str] = None):
        # 7 dilated conv layers, dilations 1..4..1 -> radius sum(d_i)
        self.receptive_radius = 16
        self._setup(lambda: IRCNN(in_nc=n_channels, out_nc=n_channels, nc=64), None, None, None)
        if params_stack is None and ckpt_path is not None:
            if str(ckpt_path).endswith(".msgpack"):
                params_stack = load_flax_msgpack(ckpt_path)
            else:
                raw = torch.load(ckpt_path, map_location="cpu")
                sets = [positional_state_dict(raw[str(i)], self.module)
                        for i in range(IRCNN_SETS)]
                self.stack = {k: torch.stack([s[k] for s in sets]) for k in sets[0]}
        if params_stack is not None:
            self.stack = conv_stack_state_dict_from_flax(params_stack)
        elif not hasattr(self, "stack"):
            self.stack = {k: torch.stack([v] * IRCNN_SETS)
                          for k, v in self.module.state_dict().items()}

    def to(self, device):
        super().to(device)
        self.stack = {k: v.to(device) for k, v in self.stack.items()}
        return self

    @property
    def params(self):
        return dict(self.stack)

    @staticmethod
    def set_index(sigma) -> torch.Tensor:
        """[1] int64 index of the weight set for noise level ``sigma`` (its
        largest entry): ceil(255 sigma / 2) - 1, clipped to [0, 24]."""
        sig = torch.max(torch.as_tensor(sigma)).reshape(1)
        return torch.clamp(torch.ceil(sig * 255.0 / 2.0) - 1, 0, IRCNN_SETS - 1).to(torch.int64)

    def _denoise_gray(self, x, sigma, params=None):
        stack = self.stack if params is None else params
        idx = self.set_index(torch.as_tensor(sigma, dtype=x.dtype, device=x.device))
        return self._net({k: torch.index_select(v, 0, idx)[0] for k, v in stack.items()}, x)


class UNetDenoiser(_NetDenoiser, Denoiser2D):
    """The CS-MRI 'unet-nm' prior per band: input [x, sigma map], residual
    out, clipped to [0, 1]."""

    def __init__(self, params=None, ckpt_path: Optional[str] = None):
        self._setup(lambda: UNet(in_channels=2, out_channels=1), params, ckpt_path,
                    unet_state_dict_from_flax)

    def _denoise_gray(self, x, sigma, params=None):
        out = self._net(params, _with_sigma_map(x, sigma))
        return torch.minimum(torch.maximum(out, out.new_zeros(())), out.new_ones(()))


class TVDenoiser(Denoiser):
    """TV per band through the fused TV kernel, or 3-D TV (a band
    difference term couples the bands) as plain PyTorch."""

    def __init__(self, iter_num: int = 5, use_3dtv: bool = False):
        # each TV iteration propagates information one pixel
        self.receptive_radius = iter_num + 1
        self.iter_num = iter_num
        self.use_3dtv = use_3dtv

    def denoise(self, x, sigma, params=None):
        B, C, H, W = x.shape
        lam = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1)
        if self.use_3dtv:
            return tv_denoising3d_chw(x, lam, self.iter_num)
        out = tv_denoise_chw(x.reshape(B * C, H, W).contiguous(), lam, self.iter_num)
        return out.reshape(B, C, H, W)


class Augment(Denoiser):
    """Geometric self-ensemble: the average over the 8 dihedral transforms,
    as eight sequential calls of the wrapped denoiser in the JAX package's
    order (rotation k, then its horizontal flip, for k = 0..3)."""

    def __init__(self, denoiser: Denoiser):
        self.inner = denoiser

    @property
    def params(self):
        return self.inner.params

    def to(self, device):
        self.inner.to(device)
        return self

    def denoise(self, x, sigma, params=None):
        outs = []
        for k in range(4):
            xr = torch.rot90(x, k, dims=(-2, -1))
            o = denoise_with(self.inner, xr, sigma, params)
            outs.append(torch.rot90(o, -k, dims=(-2, -1)))
            xf = torch.flip(xr, dims=(-1,))
            of = denoise_with(self.inner, xf, sigma, params)
            outs.append(torch.rot90(torch.flip(of, dims=(-1,)), -k, dims=(-2, -1)))
        return sum(outs) / 8.0


class BF16Denoiser(Denoiser):
    """Run a wrapped network denoiser in bfloat16 (parameters, input,
    sigma and activations), returning float32. The wrapped denoiser is
    left as it was: its module is copied before the cast, since
    ``nn.Module.to`` converts in place."""

    def __init__(self, denoiser):
        if not isinstance(getattr(denoiser, "module", None), torch.nn.Module):
            raise TypeError(f"BF16Denoiser needs a network denoiser, got "
                            f"{type(denoiser).__name__}")
        self.denoiser = copy.copy(denoiser)
        self.denoiser.module = copy.deepcopy(denoiser.module).to(torch.bfloat16)
        r = getattr(denoiser, "receptive_radius", None)
        if r is not None:
            self.receptive_radius = r

    @property
    def params(self):
        return self.denoiser.params

    def to(self, device):
        self.denoiser.to(device)
        return self

    def denoise(self, x, sigma, params=None):
        """``params`` (float32 or bfloat16) are cast to bfloat16; the cast
        is differentiable."""
        sigma = torch.as_tensor(sigma, device=x.device).to(torch.bfloat16)
        if params is not None:
            params = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                      for k, v in params.items()}
        return denoise_with(self.denoiser, x.to(torch.bfloat16), sigma, params).to(torch.float32)


class EnsembleDenoiser(Denoiser):
    """Weighted sum of several denoisers' outputs (equal weights by
    default)."""

    def __init__(self, denoisers, weights=None):
        if len(denoisers) < 2:
            raise ValueError("an ensemble needs at least two denoisers")
        self.denoisers = list(denoisers)
        if weights is None:
            weights = [1.0 / len(denoisers)] * len(denoisers)
        if len(weights) != len(denoisers):
            raise ValueError(f"{len(weights)} weights for {len(denoisers)} denoisers")
        self.weights = [float(w) for w in weights]
        radii = [getattr(d, "receptive_radius", None) for d in self.denoisers]
        if all(r is not None for r in radii):
            self.receptive_radius = max(radii)

    @property
    def params(self):
        return [d.params for d in self.denoisers]

    def to(self, device):
        for d in self.denoisers:
            d.to(device)
        return self

    def denoise(self, x, sigma, params=None):
        """``params``: None, or one weight dict (or None) per denoiser."""
        out = 0.0
        for i, (w, d) in enumerate(zip(self.weights, self.denoisers)):
            out = out + w * denoise_with(d, x, sigma, None if params is None else params[i])
        return out


class DeepTVDenoiser(Denoiser):
    """Weighted fusion of a deep denoiser and TV outputs.

    ``weight``: a float fixes w; None computes the least-squares fusion
    weight minimizing ||w*d + (1-w)*t - x||^2 in closed form.
    """

    def __init__(self, deep_denoiser: Denoiser, tv_iter: int = 10,
                 weight: Optional[float] = None):
        self.deep = deep_denoiser
        self.tv = TVDenoiser(iter_num=tv_iter)
        self.weight = weight

    @property
    def params(self):
        return self.deep.params

    def to(self, device):
        self.deep.to(device)
        return self

    def denoise(self, x, sigma, params=None):
        d = denoise_with(self.deep, x, sigma, params)
        t = self.tv.denoise(x, sigma)
        if self.weight is not None:
            return self.weight * d + (1 - self.weight) * t
        num = torch.sum((x - t) * (d - t))
        den = torch.sum((d - t) ** 2) + 1e-12
        w = num / den
        w = torch.minimum(torch.maximum(w, w.new_zeros(())), w.new_ones(()))
        return w * d + (1 - w) * t

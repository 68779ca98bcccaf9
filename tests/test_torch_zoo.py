"""The rest of the port's denoiser zoo against the JAX package's.

Each model runs on small random params made by the JAX package's own
initialization and carried across by the converters of
``dprox_tpu_torch/utils/checkpoint.py`` (the flax ``nn.ConvTranspose``
kernels with their taps flipped and in/out swapped), on the same seeded
numpy inputs. The wrappers, the registry, the checkpoint paths of
``dprox_tpu_torch/models/convert.py`` and the DGU / derain networks are
held the same way.

Tolerances (of the output's largest magnitude, at least 1): float32
network outputs to 1e-5 (the two
frameworks sum the convolutions in different orders, and the port's
f-pooling is a doubling scan where JAX runs an associative scan: both
measured <= 1.2e-6); exact index arithmetic (IRCNN's set, the step
rules) by equality; the align-corners upsample and the pads to 1e-6.
"""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dprox_tpu.contrib import derain as jderain
from dprox_tpu.models import blocks as jblocks
from dprox_tpu.models import convert as jconvert
from dprox_tpu.models import dgu as jdgu
from dprox_tpu.models import dncnn as jdncnn
from dprox_tpu.models import optics_unet as joptics
from dprox_tpu.models import qrnn as jqrnn
from dprox_tpu.proxfn import nlm as jnlm
from dprox_tpu.proxfn.pnp import denoisers as jden
from dprox_tpu.proxfn.pnp import grunet as jgrunet
from dprox_tpu.proxfn.pnp import prior as jprior
from dprox_tpu_torch.contrib.derain import LearnableDegOp
from dprox_tpu_torch.models import blocks, convert, dgu, dncnn, optics_unet, qrnn
from dprox_tpu_torch.proxfn import nlm
from dprox_tpu_torch.proxfn.pnp import denoisers as tden
from dprox_tpu_torch.proxfn.pnp import grunet as tgrunet
from dprox_tpu_torch.proxfn.pnp.hub import find_weights
from dprox_tpu_torch.proxfn.pnp.prior import PORTED_KINDS
from dprox_tpu_torch.utils import checkpoint as ck

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the test workers share the
    CPU (as in the LP test files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_leaf(path, shape, rng, lead):
    name = str(getattr(path[-1], "key", path[-1]))
    noise = rng.randn(*lead, *shape).astype(np.float32)
    if name == "kernel":  # LeCun-normal scale over the kernel's fan-in
        return noise / np.sqrt(np.prod(shape[:-1]))
    if name in ("bn_scale", "in_gamma"):
        return 1 + 0.1 * noise
    if name == "alpha":
        return 0.25 + 0.05 * noise
    return 0.05 * noise


def _flax_params(module, *args, seed=0, stack=None):
    """Random params in the tree of ``module.init(key, *args)`` (its shapes
    from ``jax.eval_shape``, no compile), numpy-seeded; nothing starts at
    zero (SAM's image conv, the tail and the derain residual convs would
    otherwise hide the params upstream of them). ``stack``: a leading axis
    of that many independent sets."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    lead = () if stack is None else (stack,)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: _random_leaf(path, tuple(a.shape), rng, lead), shapes)


def _bare(cls, **attrs):
    """A JAX wrapper with the given attributes, without its constructor's
    eager ``module.init``."""
    obj = cls.__new__(cls)
    obj.__dict__.update(attrs)
    return obj


def _jit_denoise(j, x, sigma):
    return jax.jit(lambda a: j.denoise(a, jnp.asarray([sigma], jnp.float32)))(jnp.asarray(x))


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _close(got, ref, tol=TOL):
    """|got - ref| <= tol times the largest magnitude of ref (at least 1)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=tol * max(1.0, float(np.abs(ref).max())), rtol=0)


def _load(module, sd):
    module.load_state_dict(sd)
    return module.eval()


# --------------------------------------------------------------------- blocks

@pytest.mark.parametrize("shape,axes", [((1, 3, 5, 7), (2, 3)), ((2, 2, 1, 4), (2, 3)),
                                        ((1, 2, 3, 1, 6), (3, 4)), ((1, 1, 1, 1), (2, 3))])
def test_upsample_align_corners(shape, axes):
    """Torch's align_corners grid as a gather and a lerp, a length-1 axis
    repeated: the JAX package's function on the same array (the port NCHW,
    JAX on the same axes)."""
    x = _rand(0, *shape)
    ref = jblocks.upsample_align_corners(jnp.asarray(x), axes=axes, factor=2)
    _close(blocks.upsample_align_corners(torch.from_numpy(x), axes=axes, factor=2), ref, 1e-6)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bands", [1, 5, 8])
def test_fpool_scan(reverse, bands):
    z = 2 * _rand(1, 2, 3, bands, 4, 5) - 1
    f = _rand(2, 2, 3, bands, 4, 5)
    # JAX: NDHWC with the band axis 1
    ref = jqrnn.fpool_scan(jnp.asarray(np.moveaxis(z, 1, -1)), jnp.asarray(np.moveaxis(f, 1, -1)),
                           reverse)
    got = qrnn.fpool_scan(torch.from_numpy(z), torch.from_numpy(f), reverse)
    _close(got, np.moveaxis(np.asarray(ref), -1, 1), 1e-6)


def test_conv_transpose_carried_across():
    """flax ConvTranspose (2x2, stride 2, transpose_kernel=False) against
    torch's ConvTranspose2d with the converted weight."""
    import flax.linen as fnn

    m = fnn.ConvTranspose(5, (2, 2), strides=(2, 2), padding="VALID")
    x = _rand(3, 1, 6, 7, 4)
    p = m.init(jax.random.key(1), jnp.asarray(x))
    ref = m.apply(p, jnp.asarray(x))
    layer = torch.nn.ConvTranspose2d(4, 5, 2, stride=2)
    layer.weight.data = ck.convt_weight_from_flax(p["params"]["kernel"])
    layer.bias.data = torch.from_numpy(np.asarray(p["params"]["bias"]))
    _close(layer(torch.from_numpy(_nchw(x))), _nchw(ref))


# --------------------------------------------------------------------- DRUNet

def _drunet_pair(residual, nc=(8, 16, 32, 64), nb=1, seed=0):
    from dprox_tpu.models.drunet import UNetRes

    module = UNetRes(in_nc=4, out_nc=3, nc=nc, nb=nb)
    params = _flax_params(module, jnp.zeros((1, 64, 64, 4)), seed=seed)
    j = _bare(jden.DRUNetDenoiser, n_channels=3, min_size=256, modulo=16, residual=residual,
              module=module, params=params)
    t = tden.DRUNetDenoiser(3, params=params, nc=nc, nb=nb, residual=residual)
    return j, t


@pytest.mark.parametrize("residual", [False, True])
def test_drunet_denoise(residual):
    """UNetRes direct and residual, with the edge pad to a multiple of 16
    (a 40x52 input)."""
    j, t = _drunet_pair(residual)
    x = _rand(4, 1, 3, 40, 52)
    with torch.no_grad():
        _close(t.denoise(torch.from_numpy(x), torch.tensor([0.1])), _jit_denoise(j, x, 0.1))


def test_drunet_quadrant_split():
    """A 1x3x288x320 input is above min_size 256: four quadrants with
    8-pixel shared borders, stitched."""
    j, t = _drunet_pair(True, seed=5)
    x = _rand(6, 1, 3, 288, 320)
    with torch.no_grad():
        _close(t.denoise(torch.from_numpy(x), torch.tensor([0.05])), _jit_denoise(j, x, 0.05))


# ------------------------------------------------------------ DnCNN / IRCNN / UNet

@pytest.mark.parametrize("name,kw,in_nc", [("DnCNN", dict(nc=8, nb=5), 1),
                                           ("FDnCNN", dict(nc=8, nb=5), 2),
                                           ("IRCNN", dict(nc=8), 1)])
def test_conv_stacks(name, kw, in_nc):
    jm = getattr(jdncnn, name)(in_nc=in_nc, **kw)
    x = _rand(7, 1, 20, 24, in_nc)
    p = _flax_params(jm, jnp.asarray(x), seed=2)
    tm = _load(getattr(dncnn, name)(in_nc=in_nc, **kw), ck.conv_stack_state_dict_from_flax(p))
    with torch.no_grad():
        _close(tm(torch.from_numpy(_nchw(x))), _nchw(jax.jit(jm.apply)(p, jnp.asarray(x))))


@pytest.fixture(scope="module")
def ircnn_pair():
    """25 different random weight sets, stacked."""
    m = jdncnn.IRCNN(in_nc=1, out_nc=1, nc=64)
    stack = _flax_params(m, jnp.zeros((1, 16, 16, 1)), seed=3, stack=25)
    jstack = jax.tree.map(jnp.asarray, stack)
    return (_bare(jden.IRCNNDenoiser, module=m, params_stack=jstack, params=jstack),
            tden.IRCNNDenoiser(1, params_stack=stack))


@pytest.mark.parametrize("sigma,index", [(0.004, 0), (0.05, 6), (0.5, 24)])
def test_ircnn_set_selection(ircnn_pair, sigma, index):
    """The set index from sigma (ceil(255 sigma / 2) - 1, clipped), and the
    denoise with that set."""
    j, t = ircnn_pair
    s = torch.tensor([sigma], dtype=torch.float32)
    assert int(t.set_index(s)) == index
    x = _rand(8, 1, 2, 16, 18)
    with torch.no_grad():
        _close(t.denoise(torch.from_numpy(x), s), _jit_denoise(j, x, sigma))


def test_unet_odd_size():
    """UNetDenoiser on a 1x2x37x45 input: every up step pads the upsampled
    map to its odd-sized skip."""
    from dprox_tpu.models.unet import UNet

    m = UNet(in_channels=2, out_channels=1)
    p = _flax_params(m, jnp.zeros((1, 32, 32, 2)), seed=4)
    j = _bare(jden.UNetDenoiser, module=m, params=p)
    t = tden.UNetDenoiser(params=p)
    x = _rand(9, 1, 2, 37, 45)
    with torch.no_grad():
        _close(t.denoise(torch.from_numpy(x), torch.tensor([0.1])), _jit_denoise(j, x, 0.1))


# ------------------------------------------------------------------- 3-D nets

def test_ffdnet3d():
    from dprox_tpu.models.ffdnet import FFDNet3D

    m = FFDNet3D(in_nc=5, out_nc=4, nc=64, nb=15)
    p = _flax_params(m, jnp.zeros((1, 32, 32, 5)), seed=5)
    j = _bare(jden.FFDNet3DDenoiser, module=m, params=p)
    t = tden.FFDNet3DDenoiser(params=p, in_nc=5, out_nc=4)
    x = _rand(10, 1, 4, 19, 22)
    with torch.no_grad():
        _close(t.denoise(torch.from_numpy(x), torch.tensor([0.05])), _jit_denoise(j, x, 0.05))


def test_grunet():
    """GRUnet (base 4) through the wrapper: noise-map channel, 5 scales."""
    m = jqrnn.GRUnet(in_ch=2, out_ch=1, use_noise_map=True, bn=False, base=4)
    p = _flax_params(m, jnp.zeros((1, 4, 16, 16, 2)), seed=6)
    j = _bare(jgrunet.GRUNetDenoiser, module=m, params=p)
    t = tgrunet.GRUNetDenoiser(params=p, base=4)
    x = _rand(11, 1, 6, 32, 32)
    with torch.no_grad():
        _close(t.denoise(torch.from_numpy(x), torch.tensor([0.05])), _jit_denoise(j, x, 0.05))


@pytest.mark.parametrize("plain,is_2d", [(False, False), (True, True)])
def test_qrnn_redc3d(plain, is_2d):
    """QRNNREDC3D (BN affine before each conv, moved off identity) with
    the down/upsampling layers, and its plain 2-D-kernel variant."""
    kw = dict(in_channels=2, channels=4, num_half_layer=3, sample_idx=(1,), plain=plain,
              is_2d=is_2d)
    jm = jqrnn.QRNNREDC3D(**kw)
    x = _rand(12, 1, 5, 16, 16, 2)
    p = _flax_params(jm, jnp.asarray(x), seed=7)
    tm = _load(qrnn.QRNNREDC3D(**kw), ck.qrnn3d_state_dict_from_flax(p, 3))
    ref = jax.jit(jm.apply)(p, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))))
    _close(got, np.transpose(np.asarray(ref), (0, 4, 1, 2, 3)))


def _reference_qrnn_dict(tm, seed):
    """A reference-layout QRNN3D state dict for the port's module ``tm``:
    each conv under ``<layer>.conv.{bn,conv|deconv}`` with BatchNorm3d
    running stats before it; decoder and reconstructor convs as stride-1
    ConvTranspose3d weights (in, out, ...) under ``deconv``."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, m in tm.named_modules():
        if not isinstance(m, torch.nn.Conv3d):
            continue
        holder = name[: -len(".conv")]
        cin, cout = m.in_channels, m.out_channels
        for k, v in (("running_mean", rng.randn(cin) * 0.1), ("running_var", 1 + rng.rand(cin)),
                     ("weight", 1 + 0.1 * rng.randn(cin)), ("bias", 0.1 * rng.randn(cin))):
            sd[f"{holder}.bn.{k}"] = torch.tensor(v, dtype=torch.float32)
        w = 0.2 * rng.randn(cout, cin, *m.kernel_size)
        deconv = name.startswith(("decoder", "reconstructor"))
        if deconv:
            w = np.transpose(w, (1, 0, 2, 3, 4))
        key = f"{holder}.{'deconv' if deconv else 'conv'}"
        sd[f"{key}.weight"] = torch.tensor(w, dtype=torch.float32)
        if m.bias is not None:
            sd[f"{key}.bias"] = torch.tensor(0.1 * rng.randn(cout), dtype=torch.float32)
    return sd


def test_qrnn_reference_checkpoint():
    """A reference-layout QRNN3D state dict through the JAX package's
    qrnn_torch_to_flax and through the port's qrnn_state_dict: the same
    outputs (pre-BN as the explicit affine, deconvs flipped)."""
    kw = dict(in_channels=2, channels=4, num_half_layer=3, sample_idx=(1,))
    tm = qrnn.QRNNREDC3D(**kw)
    sd = _reference_qrnn_dict(tm, 7)
    x = _rand(13, 1, 4, 16, 16, 2)
    jm = jqrnn.QRNNREDC3D(**kw)
    # the converter matches convs by the template's creation order, which
    # only an eager init keeps (jax.tree functions sort dict keys)
    p = jconvert.qrnn_torch_to_flax({k: v.numpy() for k, v in sd.items()},
                                    jm.init(jax.random.key(0), jnp.asarray(x)))
    tm = _load(tm, convert.qrnn_state_dict(sd, tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))))
    _close(got, np.transpose(np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x))), (0, 4, 1, 2, 3)))


# ------------------------------------------------------------------ OpticsUNet

def test_optics_unet_pad_and_forward():
    x = _rand(14, 1, 40, 50, 3)
    padded = joptics.pad_to_ratio_of_32(jnp.asarray(x))
    tp = optics_unet.pad_to_ratio_of_32(torch.from_numpy(_nchw(x)))
    assert tuple(tp.shape) == (1, 3, 64, 64)
    _close(tp, _nchw(padded), 0)
    _close(optics_unet.unpad_from_ratio_of_32(tp, (1, 3, 40, 50)), _nchw(x), 0)
    jm = joptics.OpticsUNet(base_features=4)
    p = _flax_params(jm, jnp.asarray(x), seed=8)
    tm = _load(optics_unet.OpticsUNet(base_features=4), ck.optics_unet_state_dict_from_flax(p))
    with torch.no_grad():
        _close(tm(torch.from_numpy(_nchw(x))), _nchw(jax.jit(jm.apply)(p, jnp.asarray(x))))


# ------------------------------------------------------------------------ DGU

DGU_KW = dict(n_feat=8, scale_unetfeats=4, scale_orsnetfeats=4)


@pytest.fixture(scope="module")
def dgu_pair():
    jm = jdgu.DGUDenoiser(**DGU_KW)
    p = _flax_params(jm, jnp.zeros((1, 32, 32, 3)), seed=9)
    tm = dgu.DGUDenoiser(**DGU_KW)
    return jm, p, _load(tm, ck.dgu_state_dict_from_flax(p, tm.state_dict().keys()))


def test_dgu_stages(dgu_pair):
    """first / middle / last with the explicit carry (features, decoder
    features, SAM features), stage by stage."""
    jm, p, tm = dgu_pair
    v = _rand(15, 1, 32, 32, 3)

    @jax.jit
    def stages(p, v):
        x, c = jm.apply(p, v, method="first")
        x2, c2 = jm.apply(p, x, c, method="middle")
        return x, c, x2, c2, jm.apply(p, x2, c2, method="last")

    jx, jc, jx2, jc2, jx3 = stages(p, jnp.asarray(v))
    with torch.no_grad():
        tx, tc = tm.first(torch.from_numpy(_nchw(v)))
        tx2, tc2 = tm.middle(tx, tc)
        tx3 = tm.last(tx2, tc2)
    for got, ref in [(tx, jx), (tx2, jx2), (tx3, jx3)] + list(zip(tc[0] + tc[1], jc[0] + jc[1])):
        _close(got, _nchw(ref))
    _close(tc2[2], _nchw(jc2[2]))


def test_dgu_reference_state_dict(dgu_pair):
    """A reference-named DGUNet state dict (random, the shapes of the
    port's module) through the JAX package's convert_dgu, and loaded into
    the port with load_state_dict: equal outputs."""
    jm, _, tm = dgu_pair
    rng = np.random.RandomState(10)
    sd = {k: torch.tensor(0.1 * rng.randn(*v.shape), dtype=torch.float32)
          for k, v in tm.state_dict().items()}
    p = jdgu.convert_dgu({k: v.numpy() for k, v in sd.items()},
                         _flax_params(jm, jnp.zeros((1, 32, 32, 3))))
    t2 = _load(dgu.DGUDenoiser(**DGU_KW), sd)
    v = _rand(16, 1, 32, 32, 3)
    with torch.no_grad():
        _close(t2(torch.from_numpy(_nchw(v))), _nchw(jax.jit(jm.apply)(p, jnp.asarray(v))))


# --------------------------------------------------------------------- derain

@pytest.mark.parametrize("step,suffix", [(0, "_0"), (1, "_1"), (3, "_1"), (5, "_1"), (6, "_6")])
def test_learnable_deg_op_steps(step, suffix):
    """The step rule (0 -> _0, max_step + 1 -> _6, else _1) and forward /
    adjoint with carried params, through params[param_key]."""
    jd = jderain.LearnableDegOp(max_step=5)
    p = {n: _flax_params(m, jnp.zeros((1, 8, 8, 3)), seed=11 + i)
         for i, (n, m) in enumerate(jd.modules.items())}
    td = LearnableDegOp(max_step=5)
    assert td._select("phi", step) == "phi" + suffix == jd._select("phi", step)
    tp = {"deg_op": ck.deg_op_state_dict_from_flax(p)}
    jp = {"deg_op": jax.tree.map(jnp.asarray, p)}
    x = _rand(17, 1, 3, 12, 14)
    with torch.no_grad():
        _close(td.forward(torch.from_numpy(x), tp, step), jd.forward(jnp.asarray(x), jp, step))
        _close(td.adjoint(torch.from_numpy(x), tp, step), jd.adjoint(jnp.asarray(x), jp, step))


def test_derain_weights_load():
    """weights/derain_joint.msgpack: every leaf of deg_op and dgu lands in
    the port's modules (strict load_state_dict)."""
    tree = ck.load_flax_msgpack(find_weights("derain_joint.msgpack"))
    td = LearnableDegOp(max_step=5)
    for name, sd in ck.deg_op_state_dict_from_flax(tree["deg_op"]).items():
        td.modules[name].load_state_dict(sd)
    m = dgu.DGUDenoiser(n_feat=16, scale_unetfeats=8, scale_orsnetfeats=8)
    m.load_state_dict(ck.dgu_state_dict_from_flax(tree["dgu"], m.state_dict().keys()))


# ------------------------------------------------------------------------ NLM

def test_nlm_denoise():
    """A 5x5 search window and 3x3 patches (the default 11 and 5 run in
    tests/test_torch_zoo_golden.py's solve)."""
    x = _rand(18, 1, 3, 20, 23)
    ref = jnlm.nlm_denoise(jnp.asarray(x), jnp.asarray(0.1, jnp.float32), 5, 3)
    _close(nlm.nlm_denoise(torch.from_numpy(x), torch.tensor(0.1), 5, 3), ref)


# ---------------------------------------------------------- registry, convert

def test_registry_has_every_jax_kind():
    """The port's kinds are the JAX package's (its get_denoiser's
    ``kind == "..."`` branches)."""
    kinds = set(re.findall(r'kind == "([^"]+)"', inspect.getsource(jprior.get_denoiser)))
    assert len(kinds) == 30
    assert set(PORTED_KINDS) == kinds


def test_state_dict_roundtrip(tmp_path):
    """A DRUNet saved as a torch state dict (.pth) loads back through
    models/convert.py's passthrough; a FFDNet3D through the positional
    map, a BatchNorm after a conv folded as the JAX package folds."""
    _, t = _drunet_pair(True, seed=12)
    path = tmp_path / "drunet.pth"
    torch.save(t.module.state_dict(), path)
    t2 = tden.DRUNetDenoiser(3, ckpt_path=str(path), nc=(8, 16, 32, 64), nb=1, residual=True)
    x = torch.from_numpy(_rand(19, 1, 3, 32, 32))
    with torch.no_grad():
        assert torch.equal(t2.denoise(x, torch.tensor([0.1])), t.denoise(x, torch.tensor([0.1])))
    torch.manual_seed(13)
    sd = {"model.0.weight": torch.randn(4, 2, 3, 3), "model.0.bias": torch.randn(4),
          "model.1.weight": 1 + 0.1 * torch.randn(4), "model.1.bias": torch.randn(4),
          "model.1.running_mean": torch.randn(4), "model.1.running_var": 1 + torch.rand(4),
          "model.3.weight": torch.randn(1, 4, 3, 3), "model.3.bias": torch.randn(1)}
    ref = jconvert.fold_batchnorm({k: v.numpy() for k, v in sd.items()})
    got = convert.fold_batchnorm(sd)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-6)
    m = dncnn.FDnCNN(in_nc=2, nc=4, nb=2)
    m.load_state_dict(convert.positional_state_dict(sd, m))
    assert torch.equal(m.model[0].weight, got["model.0.weight"])


def test_ensemble_of_zoo_nets():
    """FFDNet + DRUNet EnsembleDenoiser inside DeepTV: the ensemble_tv
    structure on small random nets."""
    from dprox_tpu.models.ffdnet import FFDNet

    jd, td = _drunet_pair(True, seed=14)
    m = FFDNet(in_nc=3, out_nc=3, nc=8, nb=3, residual=True)
    pf = _flax_params(m, jnp.zeros((1, 32, 32, 3)), jnp.zeros(()), seed=15)
    jf = _bare(jden.FFDNetColorDenoiser, module=m, params=pf)
    tf = tden.FFDNetColorDenoiser(params=pf, nc=8, nb=3, residual=True)
    j = jden.DeepTVDenoiser(jden.EnsembleDenoiser([jf, jd], [0.6, 0.4]), weight=0.5)
    t = tden.DeepTVDenoiser(tden.EnsembleDenoiser([tf, td], [0.6, 0.4]), weight=0.5)
    x = _rand(20, 1, 3, 32, 36)
    with torch.no_grad():
        _close(t.denoise(torch.from_numpy(x), torch.tensor([0.05])), _jit_denoise(j, x, 0.05))


@pytest.mark.parametrize("kind,channels", [
    ("mid_drunet_color", 3), ("mid_drunet_color_tv", 3), ("drunet_color", 3), ("drunet", 1),
    ("ircnn", 2), ("unet", 2), ("grunet", 3), ("grunet_tv", 3), ("qrnn3d", 3)])
def test_kinds_without_weights_warn_and_run_untrained(kind, channels):
    """Kinds whose weight files are not in weights/ warn, as in the JAX
    package, and run with their seeded initial weights."""
    from dprox_tpu_torch.proxfn.pnp.prior import get_denoiser

    with pytest.warns(UserWarning, match="RANDOM-INITIALIZED"):
        den = get_denoiser(kind)
    x = torch.rand(1, channels, 16, 16)
    with torch.no_grad():
        out = den.denoise(x, torch.tensor([0.05]))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())

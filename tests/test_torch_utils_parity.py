"""The port's utilities against the JAX package's, on the CPU: image IO,
the timers and the trace, the hub's offline search (and CS-MRI's real
sample through it), linop rendering, pytree checkpoints, the Bayer masks,
the [H, W, B] TV forms, the misc helpers and the re-export aliases.

Tolerances: values that both packages compute with the same numpy code
are equal; float32 torch against float32 XLA 1e-6 of the largest
magnitude (the TV forms, measured <= 6e-8; the centred FFTs).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dprox_tpu as jdp
import dprox_tpu_torch as dp
from dprox_tpu.utils import checkpoint as jck
from dprox_tpu.utils import hub as jhub
from dprox_tpu.utils import io as jio
from dprox_tpu_torch.utils import checkpoint as ck
from dprox_tpu_torch.utils import hub, io, profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the test workers share the
    CPU (as in the LP test files)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _png(path, shape=(12, 16, 3), seed=0):
    from PIL import Image

    arr = (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def test_io_matches_jax(tmp_path):
    """imread (float32 in [0, 1]), imread_rgb, filter_ckpt, is_image_file
    and list_image_files equal the JAX package's; imshow draws a grid."""
    import matplotlib

    matplotlib.use("Agg")
    arr = _png(tmp_path / "a.png")
    _png(tmp_path / "b.JPG", seed=1)
    (tmp_path / "c.txt").write_text("x")
    (tmp_path / "d.png").mkdir()
    p = str(tmp_path / "a.png")
    assert np.array_equal(io.imread(p), jio.imread(p))
    assert np.array_equal(io.imread(p), arr.astype(np.float32) / 255.0)
    assert np.array_equal(io.imread_rgb(p), jio.imread_rgb(p))
    ckpt = {"net.a": 1, "net.b": 2, "other.net.c": 3}
    for remove in (True, False):
        assert io.filter_ckpt("net.", ckpt, remove) == jio.filter_ckpt("net.", ckpt, remove)
    for name in ("x.PNG", "x.jpeg", "x.tif", "x.webp", "x.txt"):
        assert io.is_image_file(name) == jio.is_image_file(name)
    assert sorted(io.list_image_files(str(tmp_path))) == sorted(
        jio.list_image_files(str(tmp_path))) == ["a.png", "b.JPG"]
    io.imshow(torch.from_numpy(arr.transpose(2, 0, 1)[None].copy()), arr, titles=["t", "a"])
    matplotlib.pyplot.close("all")


def test_timer_and_iteration_timer_on_a_cpu_solve():
    """Timer laps add up to its total; IterationTimer, as a solver
    callback, records one time between each pair of iterations."""
    timer = profiling.Timer()
    x = torch.ones(8)
    assert timer.lap(x * 2) >= 0 and timer.lap({"a": [x]}) >= 0
    assert len(timer.laps) == 2 and timer.total == sum(timer.laps)
    timer.reset()
    assert timer.laps == []

    b = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 16, 16).astype(np.float32))
    xv = dp.Variable()
    solver = dp.compile([dp.sum_squares(dp.conv(xv, np.ones((3, 3), np.float32) / 9) - b),
                         dp.nonneg(xv)], "admm", device="cpu")
    it = profiling.IterationTimer()
    solver.solve(x0=b, max_iter=5, rhos=0.1, lams=0.05, callback=it)
    assert len(it.times) == 4 and all(t >= 0 for t in it.times)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """A temporary cache searched by both packages' hubs, first."""
    cache = tmp_path / "cache"
    cache.mkdir()
    for mod in (hub, jhub):
        monkeypatch.setattr(mod, "CACHE_DIRS", [str(cache)])
    return cache


def test_hub_offline_search_matches_jax(caches):
    """load_path finds an asset at its relative path, or by its base name
    anywhere below a cache, as the JAX package's; a miss gives None or
    FileNotFoundError; download_dataset finds a cached directory;
    load_checkpoint torch.loads a cached file; downloads stay off."""
    (caches / "models").mkdir()
    (caches / "models" / "net.pth").write_bytes(b"")
    (caches / "deep" / "er").mkdir(parents=True)
    (caches / "deep" / "er" / "w.msgpack").write_bytes(b"x")
    (caches / "set1").mkdir()
    for rel in ("models/net.pth", "elsewhere/w.msgpack", "absent.bin"):
        assert hub.load_path(rel, raise_on_miss=False) == jhub.load_path(rel, raise_on_miss=False)
    assert hub.load_path("elsewhere/w.msgpack").endswith(os.path.join("deep", "er", "w.msgpack"))
    with pytest.raises(FileNotFoundError):
        hub.load_path("absent.bin")
    assert hub.download_dataset("set1") == jhub.download_dataset("set1") == str(caches / "set1")
    assert hub.download_dataset("set2") is None
    with pytest.raises(FileNotFoundError):
        hub.download_dataset("set2", raise_on_miss=True)
    torch.save({"w": torch.arange(3)}, caches / "models" / "sd.pth")
    assert torch.equal(hub.load_checkpoint("models/sd.pth")["w"], torch.arange(3))
    hub.set_download_enabled(False)
    with pytest.raises(NotImplementedError):
        hub.set_download_enabled(True)
    assert dp.utils.hf is dp.utils.huggingface is hub


def test_csmri_sample_reference_searches_the_caches(caches):
    """With the reference's CS-MRI assets in a cache, contrib.csmri.sample
    gives the real sample, equal to the JAX package's; without them, None
    and the phantom."""
    from PIL import Image
    from scipy.io import savemat

    from dprox_tpu.contrib import csmri as jcs
    from dprox_tpu_torch.contrib import csmri

    assert csmri.sample_reference() is None
    assert csmri.sample(size=32)["gt"].shape == (1, 1, 32, 32)
    (caches / "data" / "csmri" / "masks").mkdir(parents=True)
    (caches / "data" / "csmri" / "Medical_128").mkdir()
    rng = np.random.RandomState(3)
    savemat(str(caches / "data" / "csmri" / "masks" / "radial_128_2.mat"),
            {"mask": (rng.rand(128, 128) > 0.7).astype(np.float64)})
    Image.fromarray((rng.rand(128, 128) * 255).astype(np.uint8)).save(
        caches / "data" / "csmri" / "Medical_128" / "Bust.jpg")
    got, ref = csmri.sample(), jcs.sample()
    assert sorted(got) == sorted(ref)
    for k in ("y0", "x0", "ATy0", "gt", "mask"):
        assert got[k].dtype == np.asarray(ref[k]).dtype
        assert np.array_equal(got[k], np.asarray(ref[k])), k


def _graph(pkg):
    x = pkg.Variable(name="x")
    psf = np.ones((3, 3), np.float32) / 9
    k = pkg.mosaic(pkg.conv(x, psf)) + pkg.scale(2.0, pkg.grad(x))
    return x, k, pkg.sum_squares(pkg.conv_doe(x, pkg.Placeholder("psf")) - 0.5 * x)


def test_linop_text_and_dot_equal_jax(tmp_path):
    """to_text, to_dot and visualize give the JAX package's strings on the
    same tree (shared nodes once in dot); dp.visualize renders the proxfns'
    trees; a filename writes the png or, without graphviz's dot, the
    source."""
    import importlib

    # the modules (each package's linop.visualize is the function)
    jvis = importlib.import_module("dprox_tpu.linop.visualize")
    tvis = importlib.import_module("dprox_tpu_torch.linop.visualize")

    _, jk, jfn = _graph(jdp)
    _, tk, tfn = _graph(dp)
    assert tvis.to_text(tk) == jvis.to_text(jk)
    assert tvis.to_dot(tk) == jvis.to_dot(jk)
    assert dp.linop.visualize(tk) == jvis.visualize(jk)
    assert dp.visualize([tfn, tfn]) == jdp.visualize([jfn, jfn])
    assert dp.visualize() is None
    out = str(tmp_path / "tree")
    assert dp.visualize(tfn, out) == jdp.visualize(jfn)
    assert os.path.exists(out + ".png") or os.path.exists(out + ".dot")


def test_save_and_load_pytree_round_trip_and_read_each_others_files(tmp_path):
    """save_pytree / load_pytree round-trip nested dicts, lists and tuples of
    tensors, arrays and scalars; the JAX package's msgpack load_pytree reads
    the port's file, and the port reads the JAX package's."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": {"mu": [torch.zeros(2, dtype=torch.float64), np.int32(7)], "step": 3,
                    "lr": 1e-3, "name": "adam", "flag": True, "none": None},
            "pair": (torch.ones(1, dtype=torch.int64), np.arange(3, dtype=np.float16)),
            "c": np.ones(2, np.complex64), "z": 1 + 2j}
    path = str(tmp_path / "sub" / "t.msgpack")
    assert ck.save_pytree(path, tree) == "msgpack"
    back = ck.load_pytree(path, tree)
    assert torch.equal(back["w"], tree["w"]) and back["w"].dtype == torch.float32
    assert torch.equal(back["opt"]["mu"][0], tree["opt"]["mu"][0])
    assert back["opt"]["mu"][1] == 7 and back["opt"]["step"] == 3 and back["opt"]["lr"] == 1e-3
    assert back["opt"]["name"] == "adam" and back["opt"]["flag"] is True
    assert back["opt"]["none"] is None and back["z"] == 1 + 2j
    assert isinstance(back["pair"], tuple) and np.array_equal(back["pair"][1], tree["pair"][1])
    plain = ck.load_pytree(path)
    assert torch.equal(plain["w"], tree["w"]) and torch.equal(plain["pair"]["0"], tree["pair"][0])

    jtemplate = {"w": jnp.zeros((2, 3)), "opt": {"mu": [np.zeros(2), np.int32(0)], "step": 0,
                                                 "lr": 0.0, "name": "", "flag": False,
                                                 "none": None},
                 "pair": (np.zeros(1, np.int64), np.zeros(3, np.float16)),
                 "c": np.zeros(2, np.complex64), "z": 0j}
    jback = jck.load_pytree(path, jtemplate)
    assert np.array_equal(np.asarray(jback["w"]), tree["w"].numpy())
    assert np.array_equal(jback["c"], tree["c"]) and jback["z"] == 1 + 2j
    jpath = str(tmp_path / "j.msgpack")
    jck.save_pytree(jpath, {"a": {"b": np.arange(4.0, dtype=np.float32)}, "s": 2},
                    use_orbax=False)
    got = ck.load_pytree(jpath)
    assert torch.equal(got["a"]["b"], torch.arange(4.0)) and got["s"] == 2


def test_bayer_masks_match_jax():
    from dprox_tpu.utils import imaging as jim
    from dprox_tpu_torch.utils import imaging

    for shape in ((4, 6), (5, 7)):
        for a, b in zip(imaging.masks_CFA_Bayer(shape), jim.masks_CFA_Bayer(shape)):
            assert a.dtype == bool and np.array_equal(a, b)
        assert np.array_equal(imaging.bayer_mask(shape), jim.bayer_mask(shape))


@pytest.mark.parametrize("name", ["tv_denoising", "tv_denoising3d"])
def test_hwc_tv_forms_match_jax(name):
    """models.tv_denoising / tv_denoising3d on [H, W, B] against the JAX
    package's (tests/test_models.py:143, tests/test_reference_parity.py:420:
    16 x 16 x 3, lam 0.1, 10 and 20 iterations), 1e-6."""
    import dprox_tpu.models as jm

    y = np.random.RandomState(0).rand(16, 20, 3).astype(np.float32)
    for iterations in (10, 20):
        got = getattr(dp.models, name)(torch.from_numpy(y), 0.1, iterations)
        assert got.shape == y.shape
        assert _rel(got.numpy(), getattr(jm, name)(jnp.asarray(y), 0.1, iterations)) <= 1e-6


def test_misc_helpers_and_aliases_match_jax():
    """seed_everything makes torch's and numpy's draws repeat;
    outlier_correct and crop_center_region equal JAX's; the re-export
    aliases name the port's functions."""
    from dprox_tpu.utils import misc as jmisc

    dp.utils.seed_everything(5)
    a, an = torch.rand(3), np.random.rand(3)
    dp.utils.seed_everything(5)
    assert torch.equal(a, torch.rand(3)) and np.array_equal(an, np.random.rand(3))
    arr = np.random.RandomState(1).rand(30, 40, 3).astype(np.float32)
    assert np.array_equal(dp.utils.outlier_correct(arr, 2.0), jmisc.outlier_correct(arr, 2.0))
    assert np.array_equal(dp.utils.crop_center_region(arr, 11),
                          jmisc.crop_center_region(arr, 11))
    assert dp.utils.fft2 is dp.utils.fft2_center and dp.utils.ifft2 is dp.utils.ifft2_center
    x = np.random.RandomState(2).rand(1, 1, 8, 8).astype(np.complex64)
    assert _rel(np.abs(dp.utils.fft2(torch.from_numpy(x)).numpy()),
                np.abs(np.asarray(jdp.utils.fft2(jnp.asarray(x))))) <= 1e-6
    assert dp.linalg.LinearSolve is dp.linalg.linear_solve
    v = np.linspace(-1, 1, 9).astype(np.float32)
    assert np.array_equal(dp.proxfn.soft_threshold(torch.from_numpy(v), 0.3).numpy(),
                          np.asarray(jdp.proxfn.soft_threshold(jnp.asarray(v), 0.3)))
    assert dp.CACHE_DIR == jdp.CACHE_DIR and dp.CACHE_DIRS[:3] == jdp.CACHE_DIRS[:3]
    assert isinstance(dp.array(np.ones(2)), np.ndarray) and dp.array(np.ones(2)).is_dp_array
    assert dp.contrib.restoration is dp.utils.imaging
    assert dp.contrib.mosaicing_np is dp.utils.mosaicing

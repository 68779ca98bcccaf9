"""What a cell feeds both sides: seeded images, observations, the schedule
and the denoiser's weights, all made or read by the benchmark itself.

Images are a seeded copy of the port's ``utils/imaging._synthetic_face``
(smooth gradients, texture, sharp-edged discs, noise), made on the card:
each image of a cell's pool draws its own discs and noise from the run's
seed, is cut from a larger canvas at a seeded offset, flipped and has its
channels reordered, so that every seed gives the same sizes and amounts
of work on other content.
"""
from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .reference.ops import psf2otf

ROOT = Path(__file__).resolve().parents[1]


def synthetic_face(h: int, w: int, rng: np.random.Generator, gen: torch.Generator,
                   device) -> torch.Tensor:
    """``_synthetic_face`` with its discs drawn from ``rng`` and its noise
    from ``gen``, made on ``device``: [3, h, w] float32 in [0, 1]."""
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device=device),
                            torch.linspace(0, 1, w, device=device), indexing="ij")
    two_pi = 2 * math.pi
    base = torch.stack([0.55 + 0.35 * torch.sin(two_pi * (3 * xx + yy)),
                        0.5 + 0.3 * torch.cos(two_pi * (xx - 2 * yy)),
                        0.45 + 0.35 * torch.sin(two_pi * (xx * yy * 4 + 0.3))])
    for _ in range(6):
        cy, cx = (int(v) for v in rng.integers(40, (h - 40, w - 40)))
        r = int(rng.integers(10, 60))
        mask = (yy * h - cy) ** 2 + (xx * w - cx) ** 2 < r ** 2
        color = torch.as_tensor(rng.random(3), dtype=torch.float32, device=device)
        base = torch.where(mask, color[:, None, None], base)
    base += 0.05 * torch.randn(base.shape, generator=gen, device=device)
    return base.clamp_(0.0, 1.0)


def image_pool(seed: int, n: int, size: int, device, margin: int = 64) -> torch.Tensor:
    """``n`` distinct [3, size, size] float32 images drawn from ``seed``, as
    one [n, 3, size, size] tensor on ``device``."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 63 - 1)))
    canvas = max(size + margin, 96)  # the face's discs need a side above 80
    out = []
    for _ in range(n):
        img = synthetic_face(canvas, canvas, rng, gen, device)
        y0, x0 = (int(v) for v in rng.integers(0, canvas - size + 1, size=2))
        img = img[:, y0:y0 + size, x0:x0 + size]
        flips = [d for d in (1, 2) if rng.random() < 0.5]
        if flips:
            img = torch.flip(img, flips)
        out.append(img[torch.as_tensor(rng.permutation(3), device=device)])
    return torch.stack(out).contiguous()


def gaussian_psf(size: int, sigma: float) -> np.ndarray:
    """MATLAB's fspecial('gaussian', size, sigma), float32 [size, size]."""
    half = (size - 1.0) / 2.0
    y, x = np.meshgrid(np.arange(-half, half + 1), np.arange(-half, half + 1), indexing="ij")
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    return (h / h.sum()).astype(np.float32)


def blur(img: torch.Tensor, otf: torch.Tensor) -> torch.Tensor:
    """Circular convolution of [N, C, H, W] images with a PSF given by its
    float64 OTF, computed in float64 and rounded to float32."""
    return torch.fft.ifft2(otf * torch.fft.fft2(img.double())).real.float()


def observations(traffic: dict, seed: int, psf: np.ndarray, device) -> torch.Tensor:
    """The cell's pool of blurred images, [pool, batch, 3, size, size],
    blurred an image at a time so that set-up's float64 FFTs do not set
    the run's peak memory."""
    n, batch, size = traffic["pool"], traffic["batch"], traffic["size"]
    images = image_pool(seed, n * batch, size, device)
    otf = torch.from_numpy(psf2otf(psf, (size, size))).to(device)
    out = torch.cat([blur(images[i:i + 1], otf) for i in range(n * batch)])
    return out.reshape(n, batch, 3, size, size)


def schedule(traffic: dict, device):
    """The cell's (rhos, lams) on ``device``, one of each an iteration."""
    sched = traffic["schedule"]
    if sched["kind"] != "log_descent":
        raise ValueError(f"unknown schedule kind {sched['kind']!r}")
    rhos, lams = log_descent(sched["upper"], sched["lower"], traffic["iterations"])
    return torch.from_numpy(rhos).to(device), torch.from_numpy(lams).to(device)


def log_descent(upper: float, lower: float, iterations: int):
    """The port's ``log_descent`` schedule (w = 1, lam = 0.23, sigma =
    0.255 / 255, squared noise levels): (rhos, lams) as float32 arrays."""
    sigmas = (np.logspace(np.log10(upper), np.log10(lower), iterations).astype(np.float32)
              / 255.0)
    sigma = 0.255 / 255
    rhos = np.array([0.23 * (sigma ** 2) / (s ** 2) for s in sigmas], np.float32)
    return rhos, (sigmas ** 2).astype(np.float32)


# --------------------------------------------------------------------------- #
# flax msgpack weights, read without flax, msgpack or the port
# --------------------------------------------------------------------------- #

class _Msgpack:
    """The part of msgpack the shipped weight files use: maps, strings,
    binary, arrays, ints, floats, nil, bool, and flax's ndarray extension
    (type 1: a msgpack triple of shape, dtype name and raw bytes)."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.buf[self.pos - n:self.pos].tobytes()

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
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
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
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
        if code != 1:
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = _Msgpack(data).obj(raw=True)
        return np.frombuffer(raw, dtype=np.dtype(dtype.decode())).reshape(shape).copy()


def read_msgpack(path) -> dict:
    reader = _Msgpack(Path(path).read_bytes())
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def ffdnet_weights(path) -> Dict[str, torch.Tensor]:
    """FFDNet's flax params (``params/Conv_i/Conv_0/{kernel, bias}``, kernels
    HWIO) as ``convs.i.{weight, bias}`` tensors, kernels OIHW."""
    params = read_msgpack(ROOT / path)["params"]
    out = {}
    for i in range(len(params)):
        layer = params[f"Conv_{i}"]["Conv_0"]
        kernel = np.asarray(layer["kernel"], np.float32)
        out[f"convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return out

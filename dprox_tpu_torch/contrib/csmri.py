"""CS-MRI data, masks and the prox-first ``CustomADMM``.

Counterpart of dprox_tpu/contrib/csmri.py. The data are deterministic
synthetic problems built in numpy (radial k-space masks, a Shepp-Logan
phantom), the same arrays the JAX package builds, plus the loader of the
reference's .mat evaluation format.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..algo.admm import ADMM


def _fft2c(x):
    x = np.fft.ifftshift(x, axes=(-2, -1))
    return np.fft.fftshift(np.fft.fft2(x, norm="ortho"), axes=(-2, -1))


def _ifft2c(x):
    x = np.fft.ifftshift(x, axes=(-2, -1))
    return np.fft.fftshift(np.fft.ifft2(x, norm="ortho"), axes=(-2, -1))


def radial_mask(shape=(128, 128), num_lines: int = 40, seed: int = 0) -> np.ndarray:
    """Radial k-space undersampling mask, applied to centred spectra."""
    H, W = shape
    cy, cx = H / 2 - 0.5, W / 2 - 0.5
    mask = np.zeros(shape, bool)
    rng = np.random.RandomState(seed)
    angles = np.linspace(0, np.pi, num_lines, endpoint=False)
    angles += rng.rand(num_lines) * (np.pi / num_lines) * 0.1
    rr = np.arange(-max(H, W), max(H, W), 0.5)
    for a in angles:
        ys = np.clip(np.round(cy + rr * np.sin(a)).astype(int), 0, H - 1)
        xs = np.clip(np.round(cx + rr * np.cos(a)).astype(int), 0, W - 1)
        mask[ys, xs] = True
    return np.fft.fftshift(mask)  # the lines are drawn around the center


def shepp_logan(size: int = 128) -> np.ndarray:
    """Shepp-Logan-like phantom in [0, 1], HxW."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij")
    img = np.zeros((size, size), np.float32)

    def ellipse(cx, cy, a, b, angle, val):
        ca, sa = np.cos(angle), np.sin(angle)
        x = (xx - cx) * ca + (yy - cy) * sa
        y = -(xx - cx) * sa + (yy - cy) * ca
        img[(x / a) ** 2 + (y / b) ** 2 <= 1] += val

    ellipse(0, 0, 0.69, 0.92, 0, 1.0)
    ellipse(0, -0.0184, 0.6624, 0.874, 0, -0.8)
    ellipse(0.22, 0, 0.11, 0.31, -0.31, -0.2)
    ellipse(-0.22, 0, 0.16, 0.41, 0.31, -0.2)
    ellipse(0, 0.35, 0.21, 0.25, 0, 0.1)
    ellipse(0, 0.1, 0.046, 0.046, 0, 0.1)
    ellipse(-0.08, -0.605, 0.046, 0.023, 0, 0.1)
    ellipse(0.06, -0.605, 0.023, 0.046, 0, 0.1)
    return np.clip(img, 0, 1)


def generate_sample(size: int = 128, num_lines: int = 40, sigma: float = 0.0,
                    seed: int = 0, gt=None):
    """One CS-MRI problem as a dict of numpy arrays: y0 (k-space
    observation), x0 = ATy0 (zero-filled adjoint), gt, mask and params
    ({"y", "mask"}). ``gt``: an [H, W] image in [0, 1] in place of the
    phantom."""
    gt = (shepp_logan(size) if gt is None else np.asarray(gt, np.float32))[None]  # [1,H,W]
    mask = radial_mask((size, size), num_lines, seed)[None]
    y0 = _fft2c(gt.astype(np.complex64))
    if sigma > 0:
        rng = np.random.RandomState(seed)
        y0 = y0 + sigma * (rng.randn(*y0.shape) + 1j * rng.randn(*y0.shape))
    y0 = np.where(mask, y0, 0).astype(np.complex64)
    ATy0 = _ifft2c(y0).astype(np.complex64)
    return {"y0": y0[None], "x0": ATy0[None], "ATy0": ATy0[None], "gt": gt[None],
            "mask": mask[None].astype(bool), "params": {"y": y0[None], "mask": mask[None]}}


def sample(name: Optional[str] = None, size: int = 128):
    """One CS-MRI problem: the reference's real sample where
    ``sample_reference`` finds its assets in the hub caches, else the
    synthetic phantom."""
    real = sample_reference(name or "Bust.jpg")
    if real is not None:
        return real
    return generate_sample(size=size)


def sample_reference(name: str = "Bust.jpg"):
    """The reference's real CS-MRI sample: the radial mask
    (data/csmri/masks/radial_128_2.mat) applied to the centred orthonormal
    spectrum of a Medical_128 image (data/csmri/Medical_128/<name>), the
    zero-filled adjoint as x0; the dict of ``generate_sample``, or None
    when either asset is not in the hub caches (``utils.hub``)."""
    from ..utils import hub

    mask_path = hub.load_path("data/csmri/masks/radial_128_2.mat",
                              repo_type="datasets", raise_on_miss=False)
    img_path = hub.load_path(f"data/csmri/Medical_128/{name}",
                             repo_type="datasets", raise_on_miss=False)
    if mask_path is None or img_path is None:
        return None
    from PIL import Image
    from scipy.io import loadmat

    mask = loadmat(mask_path)["mask"].astype(bool)
    target = np.asarray(Image.open(img_path).convert("L"), np.float32) / 255.0
    y0 = _fft2c(target[None, None].astype(np.complex64))
    y0 = np.where(mask[None, None], y0, 0).astype(np.complex64)
    ATy0 = _ifft2c(y0).astype(np.complex64)
    return {"y0": y0, "x0": ATy0, "ATy0": ATy0, "gt": target[None, None],
            "mask": mask[None, None], "params": {"y": y0, "mask": mask[None, None]}}


def load_data(path: str):
    """Load a sample in the reference's .mat evaluation format: (re, im)
    pairs on a trailing axis for x0, y0, ATy0 and sigma_n, the mask
    expanded to a leading axis."""
    from scipy.io import loadmat

    mat = loadmat(path)
    for k in ("__globals__", "__header__", "__version__"):
        mat.pop(k, None)
    if "name" in mat:
        mat["name"] = mat["name"].item()

    def c2r(x):
        return x[..., 0]

    def as_complex(x):
        return x[..., 0] + 1j * x[..., 1]

    mat["output"] = c2r(mat["ATy0"])
    mat["input"] = as_complex(mat["x0"])
    mat["x0"] = as_complex(mat["x0"])
    mat["y0"] = as_complex(mat["y0"])
    mat["mask"] = np.expand_dims(mat["mask"], 0).astype("bool")
    mat["sigma_n"] = c2r(mat["sigma_n"])
    mat["params"] = {"y": mat["y0"], "mask": mat["mask"]}
    return mat


class CSMRIDataset:
    """Synthetic CS-MRI problems over a cycle of line counts."""

    def __init__(self, size: int = 128, num_samples: int = 8, sigma: float = 0.0,
                 num_lines=(30, 40, 50)):
        self.samples = [generate_sample(size, num_lines[i % len(num_lines)], sigma, seed=i)
                        for i in range(num_samples)]

    def __getitem__(self, i):
        return self.samples[i % len(self.samples)]

    def __len__(self):
        return len(self.samples)


class CustomADMM(ADMM):
    """The prox-first iteration order used for CS-MRI; state (x, (z,), u),
    complex64 where the x-update is a k-space solve."""

    def _iter(self, state, rho, lam, step, params, aux):
        x, z, u = state
        z0 = z[0]
        # prox outputs are real (the denoiser takes the real part): cast back
        x_new = [fn.prox(z0 - u[i], lam[i], params=params, step=step,
                         offset=aux.offsets[i]).to(z0.dtype)
                 for i, fn in enumerate(self.psi_fns)]
        b = [x_new[i] + u[i] for i in range(len(self.psi_fns))]
        z_new = self.least_square.solve(b, rho, params=params, var_shapes=self._var_shapes(z0))
        u_new = tuple(u[i] + x_new[i] - z_new for i in range(len(self.psi_fns)))
        return (x_new[0], (z_new,), u_new)

    def initialize(self, x0, params, v=None):
        if getattr(self.least_square, "complex_state", False):
            x0 = x0.to(torch.complex64)
        return (x0, (x0,), tuple(torch.zeros_like(x0) for _ in self.psi_fns))


def complex2channel(x):
    """[B,1,H,W] complex -> [B,2,H,W] (re, im) channels."""
    x = torch.as_tensor(x)
    return torch.cat([x.real, x.imag], dim=1)


def custom_policy_ob_pack_fn(variables, x0, T, aux_state):
    """The CS-MRI policy observation: solver variables, k-space data,
    x0, time, mask and noise channels."""
    parts = [torch.as_tensor(variables), torch.as_tensor(x0), torch.as_tensor(T)]
    if aux_state is not None:
        parts.insert(1, complex2channel(aux_state["y0"]))
        parts.append(torch.as_tensor(aux_state["mask"]).to(torch.float32))
        if "sigma_n" in aux_state:
            parts.append(torch.as_tensor(aux_state["sigma_n"]).to(torch.float32))
    out = torch.cat(parts, dim=1)
    return out.real if out.is_complex() else out

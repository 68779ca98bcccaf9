"""Image reading and display, checkpoint filtering, image listings.

Counterpart of dprox_tpu/utils/io.py. imageio, PIL and matplotlib are
optional: each is imported inside the function that needs it, so the
package imports without them.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from .misc import to_ndarray

IMAGE_EXTENSIONS = [".jpg", ".jpeg", ".png", ".gif", ".bmp", ".tiff", ".webp"]


def imread(path: str) -> np.ndarray:
    """Read an image as float32 in [0, 1] (imageio, else PIL)."""
    try:
        import imageio

        img = imageio.imread(path)
    except ImportError:
        from PIL import Image

        img = np.asarray(Image.open(path))
    return np.float32(img) / 255.0


def imread_rgb(path: str) -> np.ndarray:
    """Read an image as uint8 RGB, HxWx3."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def imshow(*imgs, maxcol: int = 3, gray: bool = False, titles=None, off_axis: bool = True):
    """Show images (tensors or arrays, BCHW or HWC) in a grid of at most
    ``maxcol`` columns; values above 2 are taken as 0..255."""
    import matplotlib.pyplot as plt

    if len(imgs) != 1:
        plt.figure(figsize=(10, 5), dpi=300)
    row = (len(imgs) - 1) // maxcol + 1
    col = maxcol if len(imgs) >= maxcol else len(imgs)
    for idx, img in enumerate(imgs):
        img = to_ndarray(img, debatch=True)
        if img.max() > 2:
            img = img / 255
        img = img.clip(0, 1)
        if gray:
            plt.gray()
        plt.subplot(row, col, idx + 1)
        plt.imshow(img)
        if titles is not None:
            plt.title(titles[idx])
        if off_axis:
            plt.axis("off")
    plt.show()


def filter_ckpt(prefix: str, ckpt: dict, remove_prefix: bool = True) -> dict:
    """The entries of ``ckpt`` whose key starts with ``prefix`` (without
    it, unless ``remove_prefix`` is False)."""
    out = {}
    for k, v in ckpt.items():
        if k.startswith(prefix):
            out[k.replace(prefix, "", 1) if remove_prefix else k] = v
    return out


def is_image_file(filename: str) -> bool:
    return any(filename.lower().endswith(ext) for ext in IMAGE_EXTENSIONS)


def list_image_files(directory: str) -> List[str]:
    """Names of the image files directly in ``directory``."""
    return [f for f in os.listdir(directory)
            if os.path.isfile(os.path.join(directory, f)) and is_image_file(f)]

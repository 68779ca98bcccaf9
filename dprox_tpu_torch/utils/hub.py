"""Asset lookup: weights and datasets found in local caches.

Counterpart of dprox_tpu/utils/hub.py's offline search path
(``load_path``, ``load_checkpoint``, ``download_dataset``). The port has
no download path: downloads stay off, as the JAX package leaves them, and
a miss says where to put the file.
"""
from __future__ import annotations

import os
from typing import Optional

CACHE_DIRS = [
    os.environ.get("DPROX_CACHE", ""),
    os.path.expanduser("~/.cache/dprox"),
    os.path.expanduser("~/.cache/dprox_tpu"),
    os.path.join(os.path.dirname(__file__), "..", "..", "weights"),
]


def set_download_enabled(enabled: bool) -> None:
    """Downloads are off in the port; asking to turn them on raises."""
    if enabled:
        raise NotImplementedError(
            "the PyTorch port has no hub download path; place the asset in one of "
            f"{[d for d in CACHE_DIRS if d]}")


def _search(rel_path: str) -> Optional[str]:
    """``rel_path`` under a cache directory, else the first file of its
    base name anywhere below one, in the order of ``CACHE_DIRS``."""
    fname = os.path.basename(rel_path)
    for d in CACHE_DIRS:
        if not d or not os.path.isdir(d):
            continue
        cand = os.path.join(d, rel_path)
        if os.path.exists(cand):
            return cand
        for root, _, files in os.walk(d):
            if fname in files:
                return os.path.join(root, fname)
    return None


def load_path(rel_path: str, repo_type: str = "models",
              raise_on_miss: bool = True) -> Optional[str]:
    """Local path of the asset ``rel_path`` (``repo_type`` is the hub's
    "models" or "datasets", kept for the JAX package's signature); None
    on a miss, or FileNotFoundError with ``raise_on_miss``."""
    del repo_type
    p = _search(rel_path)
    if p is None and raise_on_miss:
        raise FileNotFoundError(
            f"asset '{rel_path}' not found in {[d for d in CACHE_DIRS if d]}; "
            "place the file in ~/.cache/dprox or the directory named by DPROX_CACHE")
    return p


def load_checkpoint(rel_path: str, **kwargs):
    """``torch.load`` of a cached checkpoint, onto the CPU."""
    import torch

    return torch.load(load_path(rel_path), map_location="cpu", **kwargs)


def download_dataset(name: str, raise_on_miss: bool = False) -> Optional[str]:
    """Local path of the cached dataset ``name``; None on a miss, or
    FileNotFoundError with ``raise_on_miss``."""
    p = _search(name)
    if p is None and raise_on_miss:
        raise FileNotFoundError(
            f"dataset '{name}' not cached locally; place it in one of "
            f"{[d for d in CACHE_DIRS if d]}")
    return p

#!/usr/bin/env python3
"""Time variant builds of the TV kernels against the repository's, on one
NVIDIA GPU, to show what each design choice of csrc/tv_denoise.cu is worth.

    python3 scripts/tv_variants.py

Each variant is csrc/tv_denoise.cu with one change made by text
substitution (the script fails if the text is not found), compiled with
nvcc and the same flags as ``ops/kernels.py`` into build/tv_variants/:

* ``backward_8_warps``: the backward's windows at 8 warps of 4, 8 and 12
  rows (128 x 32, 64, 96, as the forward's) with d y0 in registers, in
  place of 16 warps of 2, 4 and 6 rows;
* ``forward_codes_compute_only``: the forward with codes computes them but
  neither stages nor stores them (its codes are not written);
* ``forward_codes_stores_only``: the forward stages and stores a constant
  code in place of computing the codes;
* ``forward_codes_neither``: a constant code, neither staged nor stored.

At chip_smoke.TV_VJP_SHAPES it prints one JSON line per build (``repo`` and
each variant): the backward's ms (CUDA-graph replay, chip_smoke.time_ms) in
every backward window the count fits (by its size: each build's window i
has as many rows as the repository's), and the forward with codes' ms in
every forward window, each with whether its output equals the repository
build's bits (the forward_codes variants change the codes on purpose). A
forward call here also zero-fills its codes buffer, so compare the forward
times between builds, not with chip_smoke.py's.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tv_variants"

BACKWARD_WINDOWS = "constexpr Window VJP_WINDOWS[] = {{16, 2}, {16, 4}, {16, 6}};"
D_SHARED = "constexpr int VJP_D_SHARED_RPT = 6;"
ZH_CODES = "          for (int c = 0; c < 4; ++c) hn |= clip_code(pre[c], t) << (8 * c);"
ZV_CODES = "for (int c = 0; c < 4; ++c) word |= clip_code(pre[c], t) << (8 * c + 4);"
STAGE = ("cbuf[k & 1][wi0 + q][lane] = word;", "cbuf[k & 1][wi0 + RPT - 1][lane] = word;")
STORE_EACH = "      if (CODES && k > 0) store_codes(k - 1);  // complete since the barrier\n"
STORE_LAST = "    if (CODES && R > 1) store_codes(R - 2);"
STATE = "    float y[RPT][4], zh[RPT][4], zv[RPT][4];"
BACKWARD_MASKS = (
    ("static_assert(RPT * 4 <= 32, \"the masks hold one bit a cell in 32 bits\");",
     "static_assert(RPT * 4 <= 64, \"the masks hold one bit a cell in 64 bits\");"),
    ("  unsigned mh = 0, mv = 0, in = 0, keep = 0;",
     "  unsigned long long mh = 0, mv = 0, in = 0, keep = 0;"),
    ("      const unsigned b = 1u << (4 * r + c);",
     "      const unsigned long long b = 1ull << (4 * r + c);"),
    ("  const unsigned kh = keep & mh, kv = keep & mv;",
     "  const unsigned long long kh = keep & mh, kv = keep & mv;"))


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"tv_variants: {old!r} found {src.count(old)} times, not {count}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    out = {}
    v = _sub(src, BACKWARD_WINDOWS,
             "constexpr Window VJP_WINDOWS[] = {{8, 4}, {8, 8}, {8, 12}};")
    v = _sub(v, D_SHARED, "constexpr int VJP_D_SHARED_RPT = 99;")
    for old, new in BACKWARD_MASKS:  # 48 cells a lane at 12 rows
        v = _sub(v, old, new)
    out["backward_8_warps"] = v
    v = _sub(src, STAGE[0], "sink ^= word;")
    v = _sub(v, STAGE[1], "sink ^= word;")
    v = _sub(v, STORE_EACH, "")
    v = _sub(v, STORE_LAST, "    if (CODES && sink == 0x9e3779b9u) op[0] = 0.0f;")  # keeps the codes
    out["forward_codes_compute_only"] = _sub(v, STATE, "    unsigned sink = 0;\n" + STATE)
    v = _sub(src, ZH_CODES, "          for (int c = 0; c < 4; ++c) hn |= 9u << (8 * c);")
    v = _sub(v, ZV_CODES, "for (int c = 0; c < 4; ++c) word |= 9u << (8 * c + 4);", 2)
    out["forward_codes_stores_only"] = v
    v = _sub(v, STORE_EACH, "")
    out["forward_codes_neither"] = _sub(v, STORE_LAST, "")
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from dprox_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("tv_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.nvidia_smi()
    kernels.build(["tv_denoise"])
    OUT.mkdir(parents=True, exist_ok=True)
    src = (kernels.CSRC / "tv_denoise.cu").read_text().replace(
        '#include "reduce.cuh"', f'#include "{kernels.CSRC / "reduce.cuh"}"')
    libs = {"repo": kernels._lib("tv_denoise")}
    for name, text in variants(src).items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES["tv_denoise"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = kernels._RESTYPES.get(fn, ctypes.c_int)
        libs[name] = lib
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def backward(lib, codes, lam, it, g, window):
        planes, H, W = g.shape
        work = torch.empty(lib.dprox_tv_vjp_workspace(planes, H, W, it, window), device=dev)
        dy, dlam = torch.empty_like(g), torch.empty(1, device=dev)
        err = lib.dprox_tv_vjp(codes.data_ptr() if codes.numel() else None, g.data_ptr(),
                               *g.stride(), 0, dy.data_ptr(), dlam.data_ptr(), work.data_ptr(),
                               planes, H, W, it, window, stream())
        if err:
            raise RuntimeError(f"backward: cudaError {err}")
        return dy

    def forward(lib, y, lam, it, window):
        planes, H, W = y.shape
        out = torch.empty_like(y)
        codes = torch.zeros((it - 1, planes, H, -(-W // 4) * 4), dtype=torch.uint8, device=dev)
        err = lib.dprox_tv_denoise_chw(y.data_ptr(), lam.data_ptr(), 0, out.data_ptr(),
                                       codes.data_ptr(), planes, H, W, it, window, stream())
        if err:
            raise RuntimeError(f"forward: cudaError {err}")
        return out, codes

    rng = np.random.RandomState(5)
    for shape, it in cs.TV_VJP_SHAPES:
        y = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        lam = torch.full((1,), 0.05, device=dev)
        out0, codes0 = kernels._tv_launch(y, lam, it, codes=True)
        dy0, _ = kernels._tv_vjp_launch(codes0, lam, it, g)
        W = shape[-1]
        for name, lib in libs.items():
            rec = {"build": name, "shape": list(shape), "iterations": it, "backward": {},
                   "forward_with_codes": {}, "card": card}
            for j, (warps, rows) in enumerate(kernels.TV_VJP_WINDOWS):
                if warps * rows <= 2 * (it - 1):
                    continue
                same = torch.equal(backward(lib, codes0, lam, it, g, j), dy0)
                rec["backward"][f"128x{warps * rows}"] = {"bits_equal": same, "ms": cs.time_ms(
                    lambda: backward(lib, codes0, lam, it, g, j))}
            for i, (warps, rows) in enumerate(kernels.TV_WINDOWS):
                if warps * rows <= 2 * it:
                    continue
                out, codes = forward(lib, y, lam, it, i)
                same = torch.equal(out, out0) and torch.equal(codes[..., :W], codes0[..., :W])
                rec["forward_with_codes"][f"128x{warps * rows}"] = {
                    "bits_equal": same, "ms": cs.time_ms(lambda: forward(lib, y, lam, it, i))}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

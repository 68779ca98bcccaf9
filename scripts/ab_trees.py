#!/usr/bin/env python3
"""Time the port's TV and reduction kernels, and the paths that run them,
in several source trees, in turns, on one NVIDIA GPU.

    python3 scripts/ab_trees.py TREE [TREE ...]

Each TREE is a checkout of the repository: for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists, and
``.`` for the working tree. The trees are measured in the order given, one
process each, so that the order "parent, change, change, parent" spreads
the card's drift over both. A tree's process imports that tree's
dprox_tpu_torch and chip_smoke (its kernels build under TREE/build/) and
prints JSON lines:

* ``tv_denoise_chw`` at 3x512x512 with 10 iterations (the flagship's
  call) and 3x256x256 with 5 (paths B and B'): CUDA-graph replay and eager
  ms beside the bound, and a SHA-1 of each output, which must agree
  between trees whose TV arithmetic is the same;
* ``tv_denoise_chw_vjp`` at the four training shapes (chip_smoke's
  TV_VJP_SHAPES): the backward kernel from the forward's clip codes,
  CUDA-graph replay and eager ms beside its bound, a SHA-1 of d y0 (which
  must agree between trees whose adjoint arithmetic is the same) and d
  lam; the forward with the codes and without, CUDA-graph replay;
* the tree's own chip_smoke.phase_main and phase_marginal (the flagship:
  PSNR, marginal iterations/s, stage_ms with tv_branch);
* ``bdot`` at every row a path hands it ([1, 8208], [1, 32784], [1, 8208]
  float64, [1, 520] float64, [8, 520], 1x3x256x256) and ``fused_cg_tail``
  at 1x3x256x256 and 1x3x512x512: CUDA-graph replay and eager ms (median
  of 30 x 10 calls), beside one torch.linalg.vecdot call and the bound;
* a digest of csr_matvec's outputs on the LP operator (both directions,
  float32 and float64), which must agree between trees whose csr_matvec
  arithmetic is the same;
* the tree's own chip_smoke.phase_joint (paths B and B': inner
  iterations, outer iterations/s) and chip_smoke.phase_lp (path C: LP
  iterations, stage_ms, chunked 2048-period iterations).

Every line goes to standard output tagged with its run and tree.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA H100 datasheet)


def measure(tree: str) -> int:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import dprox_tpu_torch as dp
    from dprox_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("ab_trees: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    kernels.build()
    rng = np.random.RandomState(0)
    f32, f64 = torch.float32, torch.float64
    lam = torch.full((1,), 0.05, device=dev)
    for shape, it in ((3, 512, 512), 10), ((3, 256, 256), 5):
        y = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
        out = kernels.tv_denoise_chw(y, lam, it)
        n = y.numel()
        cs.emit({"kernel": "tv_denoise_chw", "shape": list(shape), "iterations": it,
                 "sha1": hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest(),
                 "ms": cs.time_ms(lambda: kernels.tv_denoise_chw(y, lam, it)),
                 "eager_ms": cs.time_ms(lambda: kernels.tv_denoise_chw(y, lam, it), graph=False),
                 "library_ms": None, "bound_ms": cs.bound(8 * n + 4, n * (16 * (it - 1) + 6))[0],
                 "card": card})
    vrng = np.random.RandomState(7)  # its own stream: the records below keep their inputs
    for shape, it in cs.TV_VJP_SHAPES:
        y = torch.from_numpy(vrng.rand(*shape).astype(np.float32)).to(dev)
        g = torch.from_numpy(vrng.randn(*shape).astype(np.float32)).to(dev)
        _, codes = kernels._tv_launch(y, lam, it, codes=True)
        dy, dlam = kernels._tv_vjp_launch(codes, lam, it, g)
        n = y.numel()
        cs.emit({"kernel": "tv_denoise_chw_vjp", "shape": list(shape), "iterations": it,
                 "sha1": hashlib.sha1(dy.cpu().numpy().tobytes()).hexdigest(),
                 "dlam": float(dlam),
                 "ms": cs.time_ms(lambda: kernels._tv_vjp_launch(codes, lam, it, g)),
                 "eager_ms": cs.time_ms(lambda: kernels._tv_vjp_launch(codes, lam, it, g),
                                        graph=False),
                 "bound_ms": cs.bound((it - 1) * n + 8 * n + 8, 18 * n * (it - 1))[0],
                 "forward_with_codes_ms": cs.time_ms(
                     lambda: kernels._tv_launch(y, lam, it, codes=True)),
                 "forward_ms": cs.time_ms(lambda: kernels._tv_launch(y, lam, it)),
                 "forward_with_codes_bound_ms": cs.bound(8 * n + (it - 1) * n + 4,
                                                         n * (16 * (it - 1) + 6))[0],
                 "card": card})
    solver, b, _ = cs.phase_main(dp, kernels, dev)
    cs.phase_marginal(dp, solver, b, card)
    del solver, b
    for shape, dtype in [((1, 8208), f32), ((1, 32784), f32), ((1, 8208), f64),
                         ((1, 520), f64), ((8, 520), f32), ((1, 3, 256, 256), f32)]:
        p = torch.from_numpy(rng.randn(*shape)).to(device=dev, dtype=dtype)
        q = 1.5 * p + 0.1 * torch.from_numpy(rng.randn(*shape)).to(device=dev, dtype=dtype)
        item = p.element_size()
        cs.emit({"kernel": "bdot", "shape": list(shape),
                 "dtype": str(dtype).replace("torch.", ""),
                 "ms": cs.time_ms(lambda: kernels.bdot(p, q)),
                 "eager_ms": cs.time_ms(lambda: kernels.bdot(p, q), graph=False),
                 "library_ms": cs.time_ms(lambda: torch.linalg.vecdot(p.flatten(1), q.flatten(1))),
                 "bound_ms": (2 * p.numel() + p.shape[0]) * item / PEAK_BYTES_PER_S * 1e3,
                 "card": card})
    for shape in [(1, 3, 256, 256), (1, 3, 512, 512)]:
        x, r, p = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
                   for _ in range(3))
        Ap = 1.5 * p + 0.1 * torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        rs = kernels.bdot_plain(r, r)
        cs.emit({"kernel": "fused_cg_tail", "shape": list(shape), "dtype": "float32",
                 "ms": cs.time_ms(lambda: kernels.fused_cg_tail(x, r, p, Ap, rs)),
                 "eager_ms": cs.time_ms(lambda: kernels.fused_cg_tail(x, r, p, Ap, rs),
                                        graph=False),
                 "library_ms": None,
                 "bound_ms": (28 * x.numel() + 8) / PEAK_BYTES_PER_S * 1e3, "card": card})
    # csr_matvec's bits on the LP operator, both directions, float32 and
    # float64: a digest that must not differ between trees
    from dprox_tpu_torch.algo.lp import BSRMat

    A = cs.equilibrated_cep(512, 16)
    digest = hashlib.sha1()
    for dtype in (f32, f64):
        op = BSRMat(A, dtype=dtype, device=dev)
        for (indptr, indices, values, split), n in ((op.csr, A.shape[1]), (op.csrT, A.shape[0])):
            v = torch.from_numpy(rng.rand(n)).to(device=dev, dtype=dtype)
            digest.update(kernels.csr_matvec(indptr, indices, values, v, split).cpu().numpy())
    cs.emit({"kernel": "csr_matvec", "operator": "cep(512,16), A and A^T, float32 and float64",
             "sha1": digest.hexdigest(), "card": card})
    cs.phase_joint(dp, kernels, dev, card)
    cs.phase_lp(kernels, dev, card)
    return 0


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for run, tree in enumerate(trees):
        tree = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", tree],
                              capture_output=True, text=True, timeout=1500)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"run": run, "tree": tree, **json.loads(line)}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        sys.exit(measure(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))

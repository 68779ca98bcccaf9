#!/usr/bin/env python3
"""Time the training steps that run TV's backward, in several source trees,
in turns, on one NVIDIA GPU.

    python3 scripts/ab_training.py TREE [TREE ...]

Each TREE is a checkout of the repository (for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists, and
``.`` for the working tree), measured in the order given, one process
each, so that "parent, change, change, parent" spreads the card's drift
over both. A tree's process imports that tree's dprox_tpu_torch and
chip_smoke (its kernels build under TREE/build/) and prints JSON lines:

* TV forward and backward at 1x128x128 with 5 iterations (the tuners'
  call, ``torch.autograd.grad`` of the sum), eager, median of 10 x 3
  calls, and the forward alone: ``tv_train_call_ms`` of this script's own
  chip_smoke.py (the function chip_smoke.py times it with), run on the
  tree's kernels once first in the process and once last, after one
  torch.profiler session (chip_smoke.py's phase check and phase special
  time it in those two states);
* the CS-MRI tuner's training step (chip_smoke's phase special: the
  shipped autotune_csmri policy, ``train`` for one epoch on one 128x128
  sample), host ms ending in a synchronise, each of 5 after a warm-up;
* the full-width optic's training step (DOEModelConfig(): patch 748, 2244^2
  fields, res_ffdnet_color_tv, admm, 10 iterations; chip_smoke.
  doe_train_step), host ms, each of 3 after a warm-up, and its peak device
  memory above what was allocated before it.

Every line goes to standard output tagged with its run and tree.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

OWN_CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


def measure(tree: str) -> int:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import dprox_tpu_torch as dp
    from dprox_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("ab_training: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    kernels.build()

    def host_ms(fn, reps):
        fn()  # warm-up
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_script", OWN_CHIP_SMOKE)
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    fresh = own.tv_train_call_ms(kernels, dev)

    from dprox_tpu_torch.contrib import csmri

    tuner, _ = cs._special_models(dp, dev)["csmri_tuner"]()
    s = csmri.generate_sample(size=128, num_lines=40, sigma=0.05)
    dataset = [{"x0": np.real(s["x0"]).astype(np.float32), "gt": s["gt"], **s["params"]}]
    kernels.reset_launches()
    tuner.train(dataset, epochs=1, log_every=0)
    launches = {k: c for k, c in kernels.launch_counts().items() if c}
    cs.emit({"what": "autotune_csmri_train_step", "launches": launches,
             "ms": host_ms(lambda: tuner.train(dataset, epochs=1, log_every=0), 5),
             "card": card})
    del tuner

    from dprox_tpu_torch.contrib.optic import DOEModelConfig
    from dprox_tpu_torch.utils.imaging import _synthetic_face

    full = DOEModelConfig()
    fmodel, fsolver = cs.doe_build(dp, dev, config=full)
    side = full.patch_size
    _, hand_rhos = cs.doe_crops()
    rhos0 = torch.from_numpy(hand_rhos).to(dev)
    sigmas0 = dp.log_descent(80, 30, cs.DOE_ITERS)[1].to(dev)
    tparams = {"height_map_sqrt": fmodel.init_params()["height_map_sqrt"].to(dev),
               "log_rhos": torch.log(rhos0), "log_sigmas": torch.log(sigmas0)}
    gt = torch.from_numpy(np.ascontiguousarray(
        _synthetic_face(side, side).transpose(2, 0, 1)[None])).to(dev)
    noise = torch.from_numpy(
        np.random.RandomState(32).randn(1, 3, side, side).astype(np.float32)).to(dev)
    step = lambda: cs.doe_train_step(fmodel, fsolver, tparams, gt, noise)
    kernels.reset_launches()
    _, peak_mb = cs._peak_mb(step)
    launches = {k: c for k, c in kernels.launch_counts().items() if c}
    cs.emit({"what": "optic_full_train_step", "side": side, "launches": launches,
             "peak_mb": peak_mb, "ms": host_ms(step, 3), "card": card})
    del fmodel, fsolver, tparams
    lam = torch.full((1,), 0.05, device=dev)
    y = torch.rand(1, 128, 128, device=dev)
    own._kernel_ms(lambda: kernels.tv_denoise_chw(y, lam, 5))  # one profiler session
    cs.emit({"what": "tv_forward_backward", "shape": [1, 128, 128], "iterations": 5,
             "fresh": fresh, "after_a_profiler_session": own.tv_train_call_ms(kernels, dev),
             "card": card})
    return 0


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for run, tree in enumerate(trees):
        tree = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", tree],
                              capture_output=True, text=True, timeout=900)
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

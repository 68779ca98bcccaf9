#!/usr/bin/env python3
"""The two readings a cell's limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds <n> [--first-seed <s>]

For each of ``n`` seeds it builds the cell as a run does, sends every
input of the pool through the timed path once (the program) and through
the plain reference twice: as the configuration states it, and in the
precision below (the control: TF32 convolutions for a float32
configuration with TF32 off, bfloat16 for one whose convolutions run in
TF32).
It also sends every input through the timed path with the fault of an
ADMM step that returns its state unchanged. It prints one JSON line a
seed with the worst of each number that ``harness.compare`` gives, each
side against the reference. The lower reading of a limit is the largest
the program gives over the seeds; the upper, the smallest the control
gives, and the limit also stays below the fault's. The benchmark's own
runs never run this.
"""
import argparse
import contextlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def unchanged_step():
    """The fault of an ADMM step that returns its state unchanged."""
    from dprox_tpu_torch.algo.admm import ADMM

    original = ADMM._iter
    ADMM._iter = lambda self, state, *args, **kw: state
    try:
        yield
    finally:
        ADMM._iter = original


def readings(cell: str, seeds, device="cuda", pool=None) -> list:
    """One dict a seed: {"seed", "program", "control", "fault": {number:
    worst over the pool}, "least_image": {"control", "fault"}}. ``pool``
    reads that many images a seed in place of the cell's pool."""
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    entry = harness.cell_entry(bench, cell)
    mix = harness.traffic(cell)
    if pool:
        mix["pool"] = pool
    cfg = harness.config(entry["config"])
    harness.set_precision(cfg.SPEC)
    out = []
    for seed in seeds:
        case = cfg.build(mix, seed, device)
        answers = [case.call(j) for j in range(mix["pool"])]
        with unchanged_step():
            faulty = [case.call(j) for j in range(mix["pool"])]
        case.call = None
        # per number: the worst over the pool, as a run's check reads it, and
        # for the control and the fault also the least over single images
        worst = {"program": {}, "control": {}, "fault": {}}
        least = {"control": {}, "fault": {}}
        for j, answer in enumerate(answers):
            ref = case.reference(j)
            for side, got in (("program", answer), ("control", case.reference(j, control=True)),
                              ("fault", faulty[j])):
                for name, value in harness.compare(got, ref, case.observe).items():
                    worst[side][name] = max(worst[side].get(name, 0.0), value)
                    if side in least:
                        least[side][name] = min(least[side].get(name, math.inf), value)
        out.append({"seed": seed, **worst, "least_image": least})
        del case, answers
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=3_000_000_001)
    parser.add_argument("--pool", type=int, default=0, help="images a seed (0: the cell's pool)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("portbench readings: no CUDA device", file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    for row in readings(args.workload, seeds, pool=args.pool):
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

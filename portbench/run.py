#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
It sets the cell up (imports, the kernels' build, cached in build/kernels
after the first run, the weights, the compiled problem, warm calls),
drives the port's entry point in a closed loop for ``--seconds``, checks a
sample of the answers against the plain reference in portbench/reference,
and prints one JSON line last on standard output. ``--trace 1`` records a
stretch of the window with torch.profiler (under build/portbench/) and
reports the per-layer metrics instead of the end-to-end ones; it ends once
that stretch is recorded and the answers it checks are drawn. Without the
cards it asks for it exits 2 and prints no result.

A per-layer metric listed for the cell that reads nothing (its reader
returns None) exits 4 and prints no result. A reader of a span or counter
(source program_span or program_counter) may instead raise
harness.Absent(name): where the run produced that name nowhere (no event
of the trace, no counter of the program), the result line leaves the
metric out and standard error says "metric <metric>: left out, the
program has no <name>"; where it did, or where the metric reads the
device trace, the run exits 4 as for None.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's build and kernel caches stay at fixed paths in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "cache" / sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    try:
        from portbench import harness
    except ImportError as e:
        print(f"portbench: {e}; run it from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    bench = harness.load_benchmark()
    try:
        entry = harness.cell_entry(bench, args.workload)
    except KeyError as e:
        print(f"portbench: {e.args[0]}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import dprox_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: {e}; the port must sit beside portbench/", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    trace_dir = ROOT / "build" / "portbench" / f"{args.workload}.{args.seed}"
    try:
        result, checks = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                          bool(args.trace), "cuda", T0, trace_dir)
    except harness.MissingMetric as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    leaked = harness.leaked_modules()
    if leaked:
        print(f"portbench: the run loaded {', '.join(leaked)}; the benchmark measures the "
              "port alone", file=sys.stderr)
        return 3
    for line in checks:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

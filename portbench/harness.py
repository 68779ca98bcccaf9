"""The shared part of the benchmark: the registry, the timed window, the
traced stretch, the check of the answers and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it:

    portbench/configs/<config>.py    build(traffic, seed, device) -> Case
    portbench/configs/<config>.json  the configuration's sizes and limits
    portbench/traffic/<cell>.json    size, batch, iterations, schedule, pool
    portbench/metrics/<metric>.py    read(run: TracedRun) -> float or None,
                                     or raise Absent(<span or counter>)
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import trace as tr

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level module names that no process of the benchmark may load: the
#: JAX package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "dprox_tpu")
#: the sources of the per-layer metrics that may say the program has no
#: such span or counter (``Absent``); a kernel that is not found fails a run
ABSENT_SOURCES = ("program_span", "program_counter")


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #

def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(workloads: {', '.join(w['name'] for w in bench['workloads'])})")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic(name: str, base: Path = PKG) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def config(name: str, base: Path = PKG):
    """The configuration's module, ``configs/<name>.py``."""
    return _module(base / "configs" / f"{name}.py", "portbench_config_" + name.replace(".", "_"))


def metric(name: str, base: Path = PKG) -> Callable:
    """The per-layer metric's reader, ``read`` of ``metrics/<name>.py``."""
    return _module(base / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_")).read


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def leaked_modules(modules: Sequence[str] = ()) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is one of ``FORBIDDEN``."""
    names = modules or list(sys.modules)
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


# --------------------------------------------------------------------------- #
# statistics
# --------------------------------------------------------------------------- #

def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream, drawn from a
    seed (Vitter's algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng([seed, 2])

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.k:
                self.items[slot] = item
        self.seen += 1


def compare(answer: torch.Tensor, reference: torch.Tensor,
            observe: Optional[Callable] = None) -> Dict[str, float]:
    """The numbers a check may compare: the largest absolute gap between
    the answer and the reference, the gap's root mean square over the
    reference's and, given the data term's forward model ``observe``, the
    largest gap between what the two predict for the observation."""
    gap = (answer.float() - reference.float()).abs()
    out = {"max_abs_err": float(gap.max()),
           "rms_rel_err": float(gap.pow(2).mean().sqrt() / reference.float().pow(2).mean().sqrt())}
    if observe is not None:
        out["data_max_err"] = float((observe(answer.float()) - observe(reference.float())).abs().max())
    return out


def set_precision(spec: dict) -> None:
    """cuDNN's TF32 mode as the configuration states it (``tf32``); cuBLAS
    stays in float32."""
    torch.backends.cudnn.allow_tf32 = bool(spec["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = False


# --------------------------------------------------------------------------- #
# one run
# --------------------------------------------------------------------------- #

class MissingMetric(Exception):
    """A per-layer metric read nothing in a cell it is listed for."""


class Absent(Exception):
    """What a per-layer metric's reader raises where the program under test
    has no span or counter named ``source`` (a parent older than the span,
    say). The harness checks that the run produced no such name anywhere,
    and then leaves the metric out of the result line; a name the run did
    produce, or a metric whose source is not a span or counter, fails the
    run as ``MissingMetric``."""

    def __init__(self, source: str):
        super().__init__(source)
        self.source = source


@dataclass
class TracedRun:
    """What a per-layer metric reads: the traced stretch's trace, the
    port's launch counters and program counters over it, and the counts of
    its work."""

    trace: tr.Trace
    lo: float  # the stretch, in the trace's microseconds
    hi: float
    calls: int
    iterations: int       # ADMM iterations a call
    images_per_call: int
    launches: Dict[str, int]
    counts: dict
    #: the program's counters (``profiling.counts()``), by how much each
    #: moved between the profiler's start and its stop
    counters: Dict[str, int] = field(default_factory=dict)
    #: every counter the program held at the end of the run
    counter_names: FrozenSet[str] = frozenset()

    @property
    def seconds(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def names(self) -> Set[str]:
        """Every span and counter name the run produced: each event name in
        the exported trace, and each counter of the program."""
        return self.trace.names | self.counter_names

    @property
    def cg_inner(self) -> Optional[float]:
        """Inner CG iterations over the stretch, from the port's launch
        counter of ``bdot``: preconditioned CG computes one dot product to
        set up and two an inner iteration (chip_smoke.py, phase joint);
        None where no ``bdot`` ran."""
        bdot = self.launches.get("bdot", 0)
        if not bdot:
            return None
        return (bdot - self.calls * self.iterations) / 2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             t0: float, trace_dir: Optional[Path] = None, base: Path = PKG):
    """One run of ``cell``: set-up, the timed window, the traced stretch,
    the check. Returns (result, check lines); the result's keys are those
    of the contract's last line."""
    entry = cell_entry(bench, cell)
    mix = traffic(cell, base)
    if mix["config"] != entry["config"]:
        raise ValueError(f"traffic {cell} names config {mix['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    cfg = config(entry["config"], base)
    set_precision(cfg.SPEC)
    t_build = time.perf_counter()
    case = cfg.build(mix, seed, device)
    t_built = time.perf_counter()
    from dprox_tpu_torch.ops import kernels
    from dprox_tpu_torch.utils import profiling

    order_rng = np.random.default_rng([seed, 1])
    order: List[int] = []

    def next_input() -> int:
        if not order:
            order.extend(int(j) for j in order_rng.permutation(mix["pool"]))
        return order.pop(0)

    for _ in range(mix["warm_calls"]):
        case.call(next_input())
        _sync(device)
    setup_s = time.perf_counter() - t0

    kept = Reservoir(mix["checked"], seed)
    latencies: List[float] = []
    failed, first_error = 0, None
    profiler, launches, counters, counters_from = None, {}, {}, {}
    trace_from, trace_to = 1, 1 + mix["trace_calls"]
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        if trace and i == trace_from:
            profiler = _profiler(device)
            kernels.reset_launches()
            counters_from = profiling.counts()
            profiler.start()
        span = (torch.profiler.record_function(tr.CALL_SPAN) if profiler is not None
                and trace_from <= i < trace_to else contextlib.nullcontext())
        j = next_input()
        t_call = time.perf_counter()
        try:
            with span:
                out = case.call(j)
            _sync(device)
        except Exception as e:  # a call that fails counts as failed; the window goes on
            failed += 1
            first_error = first_error or "".join(traceback.format_exception(e))
            out = None
        end = time.perf_counter()
        latencies.append(end - t_call)
        if out is not None:
            kept.offer((j, out))
        i += 1
        if profiler is not None and i == trace_to:
            profiler.stop()
            launches = kernels.launch_counts()
            counters = {k: v - counters_from.get(k, 0) for k, v in profiling.counts().items()}
        # a traced run ends once its stretch is recorded and every answer
        # it checks has been drawn (or, where calls fail, at the deadline)
        drawn = kept.seen >= mix["checked"] or end >= deadline
        if (i >= trace_to and drawn) if trace else end >= deadline:
            break
    window_s = end - start
    if first_error:
        print(first_error, file=sys.stderr)

    memory_peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    traced = None
    if trace:
        traced = _read_trace(profiler, trace_dir, case, mix, launches, counters,
                             frozenset(profiling.counts()))
    case.call = out = None  # the program's state goes before the reference runs
    _sync(device)

    limits = cfg.SPEC["limits"]
    worst = {name: 0.0 for name in limits}
    references = {}
    for j, answer in kept.items:
        if j not in references:
            references[j] = case.reference(j)
        got = compare(answer, references[j], case.observe)
        for name in worst:
            worst[name] = max(worst[name], got[name])
    checks = {name: {"value": worst[name], "limit": limits[name]} for name in limits}
    correct = (failed == 0 and len(kept.items) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics, left_out = {}, []
    if trace:
        metrics, left_out = layer_metrics(bench, cell, traced, base)
    else:
        values = {"setup_s": setup_s,
                  "images_per_s": case.images_per_call * (len(latencies) - failed) / window_s,
                  "call_p95_ms": p95(latencies) * 1e3}
        for m in bench["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    result = {"correct": correct, "attempted": len(latencies), "failed": failed,
              "metrics": metrics, "device": _device(device, entry["chips"], memory_peak)}
    if traced is not None:
        busy = tr.busy_us(traced.trace.device_ops(), traced.lo, traced.hi) * 1e-6
        result["device"].update(busy_s=busy, window_s=traced.seconds)
        result["breakdown"] = tr.breakdown(traced.trace, traced.lo, traced.hi)
    result["checks"] = checks
    lines = [f"setup: {t_build - t0:.3f} s imports, {t_built - t_build:.3f} s inputs, weights "
             f"and the compiled problem, {setup_s - (t_built - t0):.3f} s warm calls (kernels "
             "built on first use)"]
    lines += left_out
    lines += [f"check {name}: {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    lines.append(f"check answers compared: {len(kept.items)} of {len(latencies)} calls, "
                 f"{failed} failed")
    return result, lines


def layer_metrics(bench: dict, cell: str, run: TracedRun,
                  base: Path = PKG) -> Tuple[Dict[str, dict], List[str]]:
    """The per-layer metrics that BENCHMARK.json lists for ``cell``, read
    from ``run``, and a line for each that is left out because the program
    has no span or counter that it reads. A metric that reads None, or
    that says a name is absent which the run produced, raises
    ``MissingMetric``."""
    metrics, left_out = {}, []
    for m in bench["per_layer"]:
        if not applies(m, cell):
            continue
        try:
            value = metric(m["name"], base)(run)
        except Absent as e:
            if m["source"] not in ABSENT_SOURCES:
                raise MissingMetric(f"{m['name']} ({m['source']}) says the program has no "
                                    f"{e.source}; only a metric of a span or counter "
                                    f"({', '.join(ABSENT_SOURCES)}) may") from e
            if not e.source or e.source in run.names:
                raise MissingMetric(f"{m['name']} says the program has no {e.source!r}, which "
                                    f"this run of {cell} produced") from e
            left_out.append(f"metric {m['name']}: left out, the program has no {e.source}")
            continue
        if value is None:
            raise MissingMetric(f"{m['name']} found nothing to read in {cell}, which "
                                "BENCHMARK.json lists it for")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, left_out


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _read_trace(profiler, trace_dir: Path, case, mix: dict, launches: dict, counters: dict,
                counter_names: FrozenSet[str]) -> TracedRun:
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "trace.json"
    profiler.export_chrome_trace(str(path))
    trace = tr.Trace.load(path)
    lo, hi = trace.window()
    return TracedRun(trace=trace, lo=lo, hi=hi, calls=len(trace.calls()),
                     iterations=case.iterations, images_per_call=case.images_per_call,
                     launches=launches, counts=case.counts, counters=counters,
                     counter_names=counter_names)


def _device(device, chips: int, memory_peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(memory_peak), "power_limit": _power_limit()}


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reads it (a card set below its
    700 W runs slower under load)."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"

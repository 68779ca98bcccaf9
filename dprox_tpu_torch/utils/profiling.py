"""Timing and tracing: a device-synchronising ``Timer``, a per-iteration
solver callback, a ``torch.profiler`` trace context, and the port's own
spans and counters.

Counterpart of dprox_tpu/utils/profiling.py. Where the JAX package waits
with ``block_until_ready``, these synchronise the CUDA device that holds
the result; a CPU tensor needs no wait (torch's CPU ops run eagerly).

Spans and counters (the port's, no JAX counterpart). The solve path opens
``span("dprox.prox")`` around every ``ProxFn.prox`` and
``span("dprox.xupdate")`` around every x-update, and each iterative solver
of ``linalg`` adds to ``count("linalg.solves")`` and
``count("linalg.iterations")``. The optic's PSF simulation
(``contrib.optic.doe_model.simulate_psf``) opens ``span("dprox.optic")``;
the backward of each of the port's autograd Functions (the kernels' in
``ops/kernels.py``, ``linalg/solve.py``'s implicit solve) opens
``span("dprox.vjp")`` and adds to ``count("ops.vjps")`` (``vjp_span``).
A span records only while a ``torch.profiler`` runs (``trace`` below, or
any other profile): then it is a range in the Chrome trace (a ``cpu_op``
event named after the span), on the kernels' clock (the profiler
attributes the kernels launched inside it to it), and a record that
``span_records()`` returns with its host time and the counters it moved.
With no profiler running a span is one shared no-op context. Counters
always count; ``counts()`` reads them.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def _wait(result) -> None:
    """Wait until every CUDA tensor in ``result`` (a tensor or a nested
    list, tuple or dict of them) is computed."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _wait(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _wait(v)


class Timer:
    """Wall-clock laps that wait for the device at each boundary."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.laps = []

    def lap(self, result=None) -> float:
        """Seconds since the last lap (or reset), after ``result`` is ready."""
        if result is not None:
            _wait(result)
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        self.laps.append(dt)
        return dt

    @property
    def total(self) -> float:
        return sum(self.laps)


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    device is present) and write a Chrome trace, ``trace.json``, under
    ``logdir``; yields the profiler. ``span_records()`` then holds the
    block's spans alone."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset_spans()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class IterationTimer:
    """Seconds between consecutive solver iterations, as a ``callback=``:

        timer = IterationTimer()
        solver.solve(..., callback=timer)
        print(timer.times)

    It waits for each iteration's state, so the solve runs at the pace of
    the device."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def __call__(self, iter, state, rho, lam):
        _wait(state[0])
        now = time.perf_counter()
        if self._t0 is not None:
            self.times.append(now - self._t0)
        self._t0 = now


# --------------------------------------------------------------------------- #
# spans and counters
# --------------------------------------------------------------------------- #

_COUNTS: Dict[str, int] = {}
_RECORDS: List[dict] = []
_OPEN = [0]  # spans open now: the depth of the next one
_OFF = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program counter ``name`` (always on)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of the program counters: ``linalg.solves`` (iterative
    solves run), ``linalg.iterations`` (their iterations), ``ops.vjps``
    (backwards of the port's autograd Functions run)."""
    return dict(_COUNTS)


def reset_counts() -> None:
    _COUNTS.clear()


def span(name: str):
    """A context that records ``name`` while a ``torch.profiler`` runs and
    does nothing otherwise (one shared object, nothing allocated)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


class _Span:
    """A span while a profiler runs: a profiler range and a record.

    The range is torch's fast record (the one its compiled code uses), not
    ``torch.profiler.record_function``: the latter's exit dispatches an
    operator that, under a profiler, grows to tens of µs once hundreds of
    operators ran inside the range (62 µs after a thousand on an H100
    machine's host, against 16), and a CG x-update ends on a drained card,
    which idles meanwhile."""

    __slots__ = ("name", "range", "record", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = {"name": self.name, "depth": _OPEN[0], "counts": dict(_COUNTS)}
        _RECORDS.append(self.record)
        _OPEN[0] += 1
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        record = self.record
        record["host_ms"] = (time.perf_counter() - self.t0) * 1e3
        self.range.__exit__(*exc)
        _OPEN[0] -= 1
        before = record["counts"]
        record["counts"] = {k: v - before.get(k, 0) for k, v in _COUNTS.items()
                            if v != before.get(k, 0)}
        return False


def vjp_span():
    """``span("dprox.vjp")``, for the body of a backward of one of the
    port's autograd Functions; adds one to ``ops.vjps`` (always on)."""
    count("ops.vjps")
    return span("dprox.vjp")


def span_records() -> List[dict]:
    """The spans recorded since the last ``reset_spans()`` (or the start of
    the last ``trace``) that have closed, in the order they opened:
    ``[{"name", "depth", "host_ms", "counts"}]``. ``depth`` counts the
    spans open around it; ``counts`` holds the counters the span moved, by
    how much. Their device time is the profiler's: the kernels it
    attributes to the range (``key_averages()``, or the Chrome trace)."""
    return [dict(r, counts=dict(r["counts"])) for r in _RECORDS if "host_ms" in r]


def reset_spans() -> None:
    _RECORDS.clear()

"""Timing and tracing: a device-synchronising ``Timer``, a per-iteration
solver callback and a ``torch.profiler`` trace context.

Counterpart of dprox_tpu/utils/profiling.py. Where the JAX package waits
with ``block_until_ready``, these synchronise the CUDA device that holds
the result; a CPU tensor needs no wait (torch's CPU ops run eagerly).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

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
    ``logdir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
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

"""The device trace of a run: capture, parsing and interval arithmetic.

A traced run records a stretch of the window with ``torch.profiler``
(CPU and CUDA activity), exports it as a Chrome trace and reads it back
here. Kernel names are classified by the table the port's chip smoke
test uses for a step's device time (``STEP_KINDS``), copied so that the
yardstick stays with the benchmark. Times are in microseconds, in the
trace's own clock, which the profiler shares between host and device
events.
"""
from __future__ import annotations

import bisect
import json
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: the span the harness records around each call of the timed path
CALL_SPAN = "portbench.call"

# a device kernel's kind, by its name: TV's forward and backward kernels,
# cuFFT, the divide kernel, cuDNN's convolutions (first match wins)
STEP_KINDS = (("tv_forward", ("tv_denoise_chw_kernel",)), ("tv_backward", ("tv_vjp",)),
              ("fft", ("fft",)), ("freq_divide", ("freq_divide",)),
              ("convolution", ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad", "winograd",
                               "implicit", "sm90_", "cutlass")))

#: the port's hand-written kernels (dprox_tpu_torch/csrc), by the wrapper
#: that launches them and the names of their device functions
PORT_KERNELS = {
    "tv_denoise_chw": ("tv_denoise_chw_kernel",),
    "tv_denoise_chw_vjp": ("tv_vjp_kernel", "tv_vjp_lam_kernel"),
    "freq_divide": ("freq_divide_kernel",),
    "fused_admm_update": ("fused_admm_update_kernel",),
    "bdot": ("bdot_row_kernel", "bdot_finish_kernel", "dot_partial_kernel"),
    "fused_cg_tail": ("cg_update_",),
    "csr_matvec": ("csr_matvec_kernel", "csr_finish_kernel"),
    "bsr_matvec": ("bsr_matvec_kernel",),
}

#: host calls that block until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D")


def kind(name: str) -> str:
    """A device kernel's kind by ``STEP_KINDS``, or "other"."""
    low = name.lower()
    return next((k for k, keys in STEP_KINDS if any(key in low for key in keys)), "other")


def port_kernel(name: str) -> Optional[str]:
    """The port's wrapper that launched this device kernel, or None for a
    library kernel."""
    return next((w for w, keys in PORT_KERNELS.items() if any(k in name for k in keys)), None)


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its trailing argument list, cut to ``limit``."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:limit]


@dataclass(frozen=True)
class Event:
    name: str
    start: float  # us
    end: float    # us
    #: the id that links a kernel, copy or set to the runtime call that
    #: launched it (None where the trace gives none)
    correlation: Optional[int] = None

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """The events of a Chrome trace, by what ran where."""

    kernels: List[Event] = field(default_factory=list)
    copies: List[Event] = field(default_factory=list)    # memcpy and memset on the device
    runtime: List[Event] = field(default_factory=list)   # CUDA runtime and driver calls
    cpu_ops: List[Event] = field(default_factory=list)   # operators on the host
    spans: List[Event] = field(default_factory=list)     # record_function spans
    other: List[Event] = field(default_factory=list)     # host ranges of any other category
    #: every event name in the exported trace, of any kind and category
    names: Set[str] = field(default_factory=set)

    @classmethod
    def from_chrome(cls, obj) -> "Trace":
        out = cls()
        for e in obj.get("traceEvents", []):
            if "name" in e:
                out.names.add(str(e["name"]))
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            link = (e.get("args") or {}).get("correlation")
            ev = Event(str(e.get("name", "")), float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       None if link is None else int(link))
            if cat == "kernel":
                out.kernels.append(ev)
            elif cat in ("gpu_memcpy", "gpu_memset"):
                out.copies.append(ev)
            elif cat in ("cuda_runtime", "cuda_driver"):
                out.runtime.append(ev)
            elif cat == "cpu_op":
                out.cpu_ops.append(ev)
            elif cat == "user_annotation":
                out.spans.append(ev)
            elif not cat.startswith("gpu_"):
                out.other.append(ev)
        for lst in (out.kernels, out.copies, out.runtime, out.cpu_ops, out.spans, out.other):
            lst.sort(key=lambda ev: (ev.start, -ev.end))
        return out

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls.from_chrome(json.load(f))

    def calls(self) -> List[Event]:
        return [s for s in self.spans if s.name == CALL_SPAN]

    def window(self) -> Tuple[float, float]:
        """From the first call's start to the last call's end."""
        calls = self.calls()
        if not calls:
            raise ValueError(f"the trace holds no {CALL_SPAN!r} span")
        return calls[0].start, max(c.end for c in calls)

    def device_ops(self) -> List[Event]:
        return sorted(self.kernels + self.copies, key=lambda ev: ev.start)

    def ranges(self, name: str) -> List[Event]:
        """The host ranges named ``name`` (a span of the program), whatever
        category the profiler filed them under: torch's fast record, which
        the port's spans use, is a ``cpu_op``; ``record_function`` a
        ``user_annotation``."""
        return sorted((e for e in self.cpu_ops + self.spans + self.other if e.name == name),
                      key=lambda ev: (ev.start, -ev.end))


def within(events: Iterable[Event], lo: float, hi: float) -> List[Event]:
    """Events that start inside [lo, hi)."""
    return [e for e in events if lo <= e.start < hi]


def merged(events: Iterable[Event], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the events' intervals, clipped to [lo, hi]."""
    spans = sorted((max(e.start, lo), min(e.end, hi)) for e in events
                   if e.end > lo and e.start < hi)
    out: List[Tuple[float, float]] = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def launched_in(trace: Trace, ranges: Iterable[Event]) -> List[Event]:
    """The kernels whose launch lies inside one of ``ranges``: the runtime
    call that the trace links to the kernel by its correlation id starts
    within a range. Nested or overlapping ranges count a kernel once."""
    cover = merged(ranges, -math.inf, math.inf)
    starts = [s for s, _ in cover]
    ids = set()
    for e in trace.runtime:
        i = bisect.bisect_right(starts, e.start) - 1
        if e.correlation is not None and i >= 0 and e.start < cover[i][1]:
            ids.add(e.correlation)
    return [k for k in trace.kernels if k.correlation in ids]


def span_kernels(trace: Trace, name: str, lo: float, hi: float) -> Optional[List[Event]]:
    """The kernels launched inside the spans named ``name`` that start in
    [lo, hi); None where the trace holds no such span at all."""
    ranges = trace.ranges(name)
    if not ranges:
        return None
    return launched_in(trace, within(ranges, lo, hi))


def busy_us(events: Iterable[Event], lo: float, hi: float) -> float:
    """Time in [lo, hi] during which at least one event ran."""
    return sum(t - s for s, t in merged(events, lo, hi))


def idle_gaps(events: Iterable[Event], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no event ran."""
    gaps, at = [], lo
    for s, t in merged(events, lo, hi):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def host_activity(times: Sequence[float], events: Sequence[Event]) -> List[str]:
    """What the host was doing at each of ``times`` (ascending): the
    innermost operator or runtime call running then, or "(between ops)".
    Host events nest, so a stack swept along the times finds it."""
    evs = sorted(events, key=lambda e: (e.start, -e.end))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(evs) and evs[i].start <= t:
            while stack and stack[-1].end <= evs[i].start:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out.append(stack[-1].name if stack else "(between ops)")
    return out


def breakdown(trace: Trace, lo: float, hi: float, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the longest idle
    time by what the host was doing, each as [[name, seconds], ...]."""
    by_op: Dict[str, float] = {}
    for e in within(trace.device_ops(), lo, hi):
        key = short_name(e.name)
        by_op[key] = by_op.get(key, 0.0) + e.dur * 1e-6
    host = [e for e in trace.cpu_ops + trace.runtime if e.end > lo and e.start < hi]
    gaps = idle_gaps(trace.device_ops(), lo, hi)
    by_host: Dict[str, float] = {}
    for (s, t), key in zip(gaps, host_activity([0.5 * (s + t) for s, t in gaps], host)):
        by_host[key] = by_host.get(key, 0.0) + (t - s) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def syncs_in_calls(trace: Trace) -> int:
    """Blocking host calls inside the timed path's spans (the harness's own
    synchronise after each call lies outside them)."""
    calls = trace.calls()
    n = 0
    for e in trace.runtime:
        if e.name in SYNC_CALLS and any(c.start <= e.start < c.end for c in calls):
            n += 1
    return n

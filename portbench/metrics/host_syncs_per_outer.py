"""Blocking device-to-host waits an outer iteration: the CUDA runtime's
synchronising calls (stream, device and event synchronises, blocking
copies) that the profiler recorded inside the timed path's spans."""
from portbench import trace as tr


def read(run):
    outer = run.calls * run.iterations
    return tr.syncs_in_calls(run.trace) / outer if outer else None

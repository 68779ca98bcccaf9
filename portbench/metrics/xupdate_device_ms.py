"""The frequency x-update's device time an iteration: cuFFT's kernels and
the port's divide kernel, summed over the stretch, over its iterations."""
from portbench import trace as tr


def read(run):
    parts = [k for k in tr.within(run.trace.kernels, run.lo, run.hi)
             if tr.kind(k.name) in ("fft", "freq_divide")]
    iterations = run.calls * run.iterations
    if not parts or not iterations:
        return None
    return sum(k.dur for k in parts) * 1e-3 / iterations

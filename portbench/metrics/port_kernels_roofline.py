"""The port's hand-written kernels against their roofline: the sum over
their launches of each launch's bound (counts.py, from the cell's shapes)
over the summed device time of their kernels. A launched kernel with no
bound in the configuration's counts is an error, not a silent gap."""
from portbench import trace as tr


def read(run):
    bounds = run.counts["kernel_bound_s"]
    launched = {k: n for k, n in run.launches.items() if n and k in tr.PORT_KERNELS}
    unbounded = sorted(k for k in launched if k not in bounds)
    if unbounded:
        raise ValueError(f"the port launched {', '.join(unbounded)}, which the configuration's "
                         "counts give no bound for: add it to work()['kernel_bound_s']")
    seconds = sum(k.dur for k in tr.within(run.trace.kernels, run.lo, run.hi)
                  if tr.port_kernel(k.name) in launched) * 1e-6
    if not launched or not seconds:
        return None
    return 100.0 * sum(n * bounds[k] for k, n in launched.items()) / seconds

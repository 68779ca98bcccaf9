"""Device kernels an ADMM iteration: every kernel the traced stretch ran
(memcpy and memset not counted), over the iterations it ran."""
from portbench import trace as tr


def read(run):
    kernels = tr.within(run.trace.kernels, run.lo, run.hi)
    iterations = run.calls * run.iterations
    return len(kernels) / iterations if kernels and iterations else None

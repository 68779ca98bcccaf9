"""The x-update's device time an ADMM iteration: the kernels launched
inside the program's ``dprox.xupdate`` spans (the frequency divide or the
CG solve, whichever the problem takes), each matched to its launch by the
trace's correlation id, summed over the stretch and divided by its
iterations. Where the program has no such span, it says so."""
from portbench import harness
from portbench import trace as tr

SPAN = "dprox.xupdate"


def read(run):
    kernels = tr.span_kernels(run.trace, SPAN, run.lo, run.hi)
    if kernels is None:
        raise harness.Absent(SPAN)
    iterations = run.calls * run.iterations
    if not kernels or not iterations:
        return None
    return sum(k.dur for k in kernels) * 1e-3 / iterations

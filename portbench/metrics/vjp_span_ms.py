"""The device time a call of the backwards of the port's autograd
Functions: the kernels launched inside the program's ``dprox.vjp`` spans
(TV's backward kernel, the frequency divide's closed-form VJP, and where
they run the fused ADMM update's, ``bdot``'s, the CG tail's and the
implicit linear solve's backwards), each matched to its launch by the
trace's correlation id, summed over the stretch and divided by its calls.
Where the program has no such span, it says so."""
from portbench import harness
from portbench import trace as tr

SPAN = "dprox.vjp"


def read(run):
    kernels = tr.span_kernels(run.trace, SPAN, run.lo, run.hi)
    if kernels is None:
        raise harness.Absent(SPAN)
    if not kernels or not run.calls:
        return None
    return sum(k.dur for k in kernels) * 1e-3 / run.calls

"""The optic's device time a call: the kernels launched inside the
program's ``dprox.optic`` spans (the PSF simulation of
``contrib.optic.doe_model.simulate_psf``: the aperture, the padded Fresnel
propagation's cuFFT calls, |field|^2, the area downsampling and the
normalisation), each matched to its launch by the trace's correlation id,
summed over the stretch and divided by its calls. The optic's backward
runs in autograd's engine, outside the span. Where the program has no
such span, it says so."""
from portbench import harness
from portbench import trace as tr

SPAN = "dprox.optic"


def read(run):
    kernels = tr.span_kernels(run.trace, SPAN, run.lo, run.hi)
    if kernels is None:
        raise harness.Absent(SPAN)
    if not kernels or not run.calls:
        return None
    return sum(k.dur for k in kernels) * 1e-3 / run.calls

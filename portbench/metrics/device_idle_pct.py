"""The share of the traced stretch in which nothing ran on the card: one
minus the union of its kernels', copies' and sets' intervals."""
from portbench import trace as tr


def read(run):
    if not run.trace.device_ops():
        return None
    busy = tr.busy_us(run.trace.device_ops(), run.lo, run.hi)
    return 100.0 * (1.0 - busy / (run.hi - run.lo))

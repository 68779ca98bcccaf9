"""Inner CG iterations an outer ADMM iteration, from the port's launch
counter of ``bdot`` (``TracedRun.cg_inner``)."""


def read(run):
    inner, outer = run.cg_inner, run.calls * run.iterations
    if inner is None or not outer:
        return None
    return inner / outer

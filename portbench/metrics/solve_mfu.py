"""The whole solve against the card's peak: the least time the stretch's
solves need (their operations counted from shapes: FFDNet's convolutions
at the peak they run against, and at the float32 peak the FFTs at 5 N
log2 N, the divide, TV, the fusion, the ADMM updates and, where CG runs,
its set-up and its inner iterations as the port's ``bdot`` counter counts
them) over the stretch's seconds. It bounds what a change to any one
kernel can claim."""
from portbench import counts


def read(run):
    per_call = run.counts.get("flops_per_call")
    if not per_call or not run.seconds:
        return None
    conv = per_call.get("ffdnet_conv", 0.0)
    rest = sum(per_call.values()) - conv
    per_cg_iteration = run.counts.get("flops_per_cg_iteration")
    if per_cg_iteration:
        if run.cg_inner is None:
            return None
        rest_cg = per_cg_iteration * run.cg_inner
    else:
        rest_cg = 0.0
    least_s = (rest * run.calls + rest_cg) / counts.PEAK_F32_OPS_PER_S
    if conv:
        least_s += conv * run.calls / run.counts["conv_peak_ops_per_s"]
    return 100.0 * least_s / run.seconds

"""FFDNet's convolution FLOPs (counted from shapes) over the summed device
time of the convolution kernels, as a share of the peak they run against:
the card's float32 peak, or its TF32 tensor-core peak where the
configuration lets cuDNN use TF32."""
from portbench import trace as tr


def read(run):
    flops = run.counts.get("ffdnet_conv_flops_per_call")
    conv = [k for k in tr.within(run.trace.kernels, run.lo, run.hi)
            if tr.kind(k.name) == "convolution"]
    seconds = sum(k.dur for k in conv) * 1e-6
    if not flops or not seconds:
        return None
    return 100.0 * flops * run.calls / seconds / run.counts["conv_peak_ops_per_s"]

"""The trace reader, the statistics and the per-layer metrics on synthetic
event lists whose answers are worked by hand."""
import pytest

from portbench import counts, harness
from portbench import trace as tr


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def synthetic_trace():
    """Two calls of 2 ADMM iterations each over [0, 100) us:

    call 1 [0, 40): kernels tv [5, 10), fft [10, 14), freq_divide [14, 16),
        conv [16, 30); a memset [30, 31); host: a sync [33, 38)
    call 2 [50, 100): tv [55, 60), conv [60, 90) overlapping fft [85, 95)
    outside the calls: a kernel [40, 45) and the harness's sync [40, 49)
    """
    ev = [_x("user_annotation", tr.CALL_SPAN, 0, 40), _x("user_annotation", tr.CALL_SPAN, 50, 50),
          _x("kernel", "void tv_denoise_chw_kernel<8, 12, false>(float const*)", 5, 5),
          _x("kernel", "void regular_fft<256u>(float2*)", 10, 4),
          _x("kernel", "void freq_divide_kernel<long>(float2 const*)", 14, 2),
          _x("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32", 16, 14),
          _x("gpu_memset", "Memset (Device)", 30, 1),
          _x("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 40, 5),
          _x("kernel", "void tv_denoise_chw_kernel<8, 12, false>(float const*)", 55, 5),
          _x("kernel", "cudnn::winograd_nonfused::winogradForwardData4x4", 60, 30),
          _x("kernel", "void vector_fft<64u>(float2*)", 85, 10),
          _x("cuda_runtime", "cudaStreamSynchronize", 33, 5),
          _x("cuda_runtime", "cudaDeviceSynchronize", 40, 9),
          _x("cuda_runtime", "cudaLaunchKernel", 2, 1),
          _x("cpu_op", "aten::item", 32, 7),
          _x("cpu_op", "aten::conv2d", 46, 20),
          {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1}]
    return tr.Trace.from_chrome({"traceEvents": ev})


def synthetic_run(launches=None, counts_=None):
    t = synthetic_trace()
    lo, hi = t.window()
    return harness.TracedRun(trace=t, lo=lo, hi=hi, calls=2, iterations=2, images_per_call=1,
                             launches=launches or {}, counts=counts_ or {})


def test_parse_and_window():
    t = synthetic_trace()
    assert len(t.kernels) == 8 and len(t.copies) == 1 and len(t.runtime) == 3
    assert len(t.cpu_ops) == 2 and len(t.calls()) == 2
    assert t.window() == (0.0, 100.0)


def test_kind_and_port_kernel():
    assert tr.kind("void tv_denoise_chw_kernel<8, 12, false>(float const*)") == "tv_forward"
    assert tr.kind("void regular_fft<256u>(float2*)") == "fft"
    assert tr.kind("sm90_xmma_fprop_implicit_gemm_f32f32") == "convolution"
    assert tr.kind("void at::native::elementwise_kernel<128, 2>(int)") == "other"
    assert tr.port_kernel("void freq_divide_kernel<long>(float2 const*)") == "freq_divide"
    assert tr.port_kernel("void bdot_finish_kernel<float>(float const*)") == "bdot"
    assert tr.port_kernel("sm90_xmma_fprop_implicit_gemm_f32f32") is None


def test_busy_idle_and_gaps():
    t = synthetic_trace()
    # busy: [5, 31) and [40, 45) and [55, 95) = 26 + 5 + 40
    assert tr.busy_us(t.device_ops(), 0, 100) == 71
    assert tr.idle_gaps(t.device_ops(), 0, 100) == [(0, 5), (31, 40), (45, 55), (95, 100)]
    run = synthetic_run()
    assert harness.metric("device_idle_pct")(run) == pytest.approx(29.0)


def test_breakdown_names_the_host_activity():
    t = synthetic_trace()
    b = tr.breakdown(t, 0, 100)
    ops = dict(b["device_ops"])
    assert ops["cudnn::winograd_nonfused::winogradForwardData4x4"] == pytest.approx(30e-6)
    assert ops["void tv_denoise_chw_kernel<8, 12, false>"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    # gap midpoints: 2.5 (cudaLaunchKernel), 35.5 (cudaStreamSynchronize
    # inside aten::item), 50 (aten::conv2d), 97.5 (nothing)
    assert gaps == pytest.approx({"cudaLaunchKernel": 5e-6, "cudaStreamSynchronize": 9e-6,
                                  "aten::conv2d": 10e-6, "(between ops)": 5e-6})
    assert [k for k, _ in b["idle_gaps"]][0] == "aten::conv2d"


def test_p95_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95(list(range(1, 21))) == 19
    assert harness.p95([3.0]) == 3.0
    assert harness.p95([5, 1, 4, 2, 3] * 4) == 5
    with pytest.raises(ValueError):
        harness.p95([])


def test_reservoir_is_seeded_and_bounded():
    a, b = harness.Reservoir(4, 17), harness.Reservoir(4, 17)
    for i in range(1000):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 4 and a.seen == 1000
    assert max(a.items) > 4  # later items get in


def test_layer_metrics_on_the_synthetic_run():
    bounds = {"tv_denoise_chw": 2e-6, "freq_divide": 1e-6}
    run = synthetic_run({"tv_denoise_chw": 2, "freq_divide": 1, "bdot": 0},
                        {"kernel_bound_s": bounds, "ffdnet_conv_flops_per_call": 67e6,
                         "conv_peak_ops_per_s": counts.PEAK_F32_OPS_PER_S,
                         "flops_per_call": {"a": 33.5e6, "b": 33.5e6}})
    assert harness.metric("launches_per_iter")(run) == 8 / 4
    # the port's kernels ran 5 + 2 + 5 us for bounds 2 * 2 + 1 us
    assert harness.metric("port_kernels_roofline")(run) == pytest.approx(100 * 5 / 12)
    # two calls of 67 MFLOP in 44 us of convolutions, against 67 TFLOP/s
    assert harness.metric("ffdnet_conv_mfu")(run) == pytest.approx(
        100 * 2 * 67e6 / 44e-6 / counts.PEAK_F32_OPS_PER_S)
    assert harness.metric("xupdate_device_ms")(run) == pytest.approx((4 + 2 + 10) * 1e-3 / 4)
    assert harness.metric("solve_mfu")(run) == pytest.approx(
        100 * 2 * 67e6 / 100e-6 / counts.PEAK_F32_OPS_PER_S)
    # one blocking call inside the spans; the harness's own lies outside
    assert harness.metric("host_syncs_per_outer")(run) == 1 / 4


def test_tf32_convolutions_are_held_to_the_tensor_cores_peak():
    run = synthetic_run({}, {"ffdnet_conv_flops_per_call": 67e6,
                             "conv_peak_ops_per_s": counts.PEAK_TF32_OPS_PER_S,
                             "flops_per_call": {"ffdnet_conv": 67e6, "fft": 6.7e6}})
    assert harness.metric("ffdnet_conv_mfu")(run) == pytest.approx(
        100 * 2 * 67e6 / 44e-6 / counts.PEAK_TF32_OPS_PER_S)
    # the least time: the convolutions at the TF32 peak, the rest at float32's
    assert harness.metric("solve_mfu")(run) == pytest.approx(
        100 * (2 * 67e6 / counts.PEAK_TF32_OPS_PER_S + 2 * 6.7e6 / counts.PEAK_F32_OPS_PER_S)
        / 100e-6)


def test_cg_counter_rule():
    # 4 outer iterations, 7 inner: one set-up bdot an outer, two an inner
    run = synthetic_run({"bdot": 4 + 2 * 7})
    assert run.cg_inner == 7
    assert harness.metric("cg_inner_per_outer")(run) == 7 / 4


def test_solve_mfu_counts_cg_iterations_from_the_counter():
    run = synthetic_run({"bdot": 4 + 2 * 7}, {"flops_per_call": {"a": 10e6},
                                             "flops_per_cg_iteration": 3e6})
    # two calls of 10 MFLOP and 7 inner iterations of 3 MFLOP in 100 us
    assert harness.metric("solve_mfu")(run) == pytest.approx(
        100 * (2 * 10e6 + 7 * 3e6) / 100e-6 / counts.PEAK_F32_OPS_PER_S)
    run.launches = {}
    assert harness.metric("solve_mfu")(run) is None


def test_metrics_with_nothing_to_read_return_none():
    empty = tr.Trace(spans=[tr.Event(tr.CALL_SPAN, 0, 10)])
    run = harness.TracedRun(trace=empty, lo=0, hi=10, calls=1, iterations=1, images_per_call=1,
                            launches={}, counts={"kernel_bound_s": {}, "flops_per_call": None,
                                                 "ffdnet_conv_flops_per_call": None})
    for name in ("launches_per_iter", "ffdnet_conv_mfu", "xupdate_device_ms",
                 "cg_inner_per_outer", "port_kernels_roofline", "device_idle_pct", "solve_mfu"):
        assert harness.metric(name)(run) is None, name


def test_a_port_kernel_without_a_bound_is_an_error():
    # a later change that puts another kernel on the path must give its
    # bound, not make the roofline fall silent
    run = synthetic_run({"tv_denoise_chw": 2, "bdot": 3},
                        {"kernel_bound_s": {"tv_denoise_chw": 2e-6}})
    with pytest.raises(ValueError, match="bdot"):
        harness.metric("port_kernels_roofline")(run)

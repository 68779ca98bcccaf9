"""The optic_doe configuration: its counts against numbers worked by hand,
its two span metrics on synthetic traces, and a run of its cell cut for
the CPU."""
import json
import math
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import counts, harness
from portbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
CELL = "optic_doe.train748"
CUT = dict(size=32, batch=2, images_per_call=2, iterations=3, pool=2, checked=2, warm_calls=1,
           trace_calls=2)


def cut_traffic():
    mix = harness.traffic(CELL)
    mix.update(CUT)
    return mix


def test_work_by_hand():
    """At a 32 patch (a 64 wave grid, padded to 96), a batch of 2 and 3
    iterations: 6 planes of 1024 points."""
    w = harness.config("optic_doe").work(cut_traffic())
    per_call = w["flops_per_call"]
    # a 3x3 conv is 18 operations a tap; FFDNet at 16^2 after the unshuffle,
    # 13 -> 96, 8 x 96 -> 96, 96 -> 12: 18 * 256 * 76128 an image, 2 images,
    # 3 forward passes and 2 backward-data passes
    assert per_call["ffdnet_conv"] == 5 * 2 * 18 * 256 * 76128
    assert w["ffdnet_conv_flops_per_call"] == per_call["ffdnet_conv"]
    # TV: 16 operations a cell an iteration, 10 iterations, 3 forward and 2 back
    assert per_call["tv"] == 5 * 16 * 6 * 1024 * 10
    # 5 N log2 N a 2-D FFT: 4 of the 3 x 96^2 field, 6 of the 3 x 32^2 PSF,
    # 17 of the 6 x 32^2 batch (9 forward, 8 backward)
    field = 5 * 3 * 96 * 96 * math.log2(96 * 96)
    assert per_call["fft"] == pytest.approx(4 * field + 6 * 5 * 3 * 1024 * 10
                                            + 17 * 5 * 6 * 1024 * 10)
    # the divide 6 operations an element and its VJP 12, 3 times
    assert per_call["divide"] == 3 * 18 * 6144
    # fusion 3, ADMM 5, x-update 3 an element each way, 3 iterations; the
    # optic's field 10 a point and its propagator's product 6, each way
    assert per_call["elementwise"] == (2 * 11 * 3 * 6144 + 2 * 10 * 3 * 64 * 64
                                       + 2 * 6 * 3 * 96 * 96)
    assert w["conv_peak_ops_per_s"] == counts.PEAK_TF32_OPS_PER_S
    bounds = w["kernel_bound_s"]
    assert set(bounds) == {"tv_denoise_chw", "tv_denoise_chw_vjp", "freq_divide"}
    # TV under grad moves y0, its output and 9 code planes of bytes (32 is a
    # multiple of 4): bytes bound it
    tv_bytes = 2 * 6 * 1024 * 4 + 9 * 6 * 1024
    assert bounds["tv_denoise_chw"] == pytest.approx(tv_bytes / counts.PEAK_BYTES_PER_S)
    assert bounds["tv_denoise_chw_vjp"] == pytest.approx(tv_bytes / counts.PEAK_BYTES_PER_S)
    # the spectrum read and written, one divisor of 3 planes
    assert bounds["freq_divide"] == pytest.approx(
        (2 * 8 * 6144 + 4 * 3 * 1024) / counts.PEAK_BYTES_PER_S)


def test_the_cell_is_listed_for_its_metrics():
    bench = harness.load_benchmark()
    listed = {m["name"] for m in bench["per_layer"] if harness.applies(m, CELL)}
    assert listed == {"launches_per_iter", "ffdnet_conv_mfu", "port_kernels_roofline",
                      "device_idle_pct", "solve_mfu", "prior_span_ms", "xupdate_span_ms",
                      "optic_span_ms", "vjp_span_ms"}
    entry = harness.cell_entry(bench, CELL)
    assert entry["chips"] == 1 and entry["config"] == "optic_doe"


def _x(cat, name, ts, dur, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def training_trace(spans=True):
    """Two calls over [0, 100) us. Host spans: dprox.optic [1, 9) and
    [51, 59); dprox.vjp [30, 36) and, on autograd's thread, [80, 90).
    Launches (runtime call at t, correlation id -> kernel): 2 (1) -> fft
    [3, 8); 5 (2) -> fft [8, 10); 20, outside every span (3) -> conv [20,
    30); 31 (4) -> tv_vjp [31, 35); 32 (5) -> tv_vjp_lam [35, 36); 52 (6) ->
    fft [52, 56); 81 (7) -> elementwise [81, 84); 85 (8) -> dgrad [85, 95),
    which counts though it ends after the span: its launch lies inside. So
    the optic's kernels ran 5 + 2 + 4 us and the backwards' 4 + 1 + 3 + 10
    us."""
    ev = [_x("user_annotation", tr.CALL_SPAN, 0, 40), _x("user_annotation", tr.CALL_SPAN, 50, 50)]
    launches = [(2, 1), (5, 2), (20, 3), (31, 4), (32, 5), (52, 6), (81, 7), (85, 8)]
    ev += [_x("cuda_runtime", "cudaLaunchKernel", t, 1, c) for t, c in launches]
    ev += [_x("kernel", "void regular_fft<748u>(float2*)", 3, 5, 1),
           _x("kernel", "void vector_fft<64u>(float2*)", 8, 2, 2),
           _x("kernel", "sm90_xmma_fprop_implicit_gemm_tf32f32", 20, 10, 3),
           _x("kernel", "void tv_vjp_kernel<16, 6>(unsigned char const*)", 31, 4, 4),
           _x("kernel", "void tv_vjp_lam_kernel(float const*)", 35, 1, 5),
           _x("kernel", "void regular_fft<2244u>(float2*)", 52, 4, 6),
           _x("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 81, 3, 7),
           _x("kernel", "sm90_xmma_dgrad_implicit_gemm_tf32f32", 85, 10, 8)]
    if spans:
        ev += [_x("cpu_op", "dprox.optic", 1, 8), _x("cpu_op", "dprox.optic", 51, 8),
               _x("cpu_op", "dprox.vjp", 30, 6), dict(_x("cpu_op", "dprox.vjp", 80, 10), tid=1)]
    return tr.Trace.from_chrome({"traceEvents": ev})


def training_run(spans=True):
    t = training_trace(spans)
    lo, hi = t.window()
    return harness.TracedRun(trace=t, lo=lo, hi=hi, calls=2, iterations=3, images_per_call=2,
                             launches={}, counts={})


def test_span_metrics_by_hand():
    run = training_run()
    assert harness.metric("optic_span_ms")(run) == pytest.approx(11e-3 / 2)
    assert harness.metric("vjp_span_ms")(run) == pytest.approx(18e-3 / 2)


@pytest.mark.parametrize("name,span", [("optic_span_ms", "dprox.optic"),
                                       ("vjp_span_ms", "dprox.vjp")])
def test_span_metrics_say_absent_without_their_span(name, span):
    with pytest.raises(harness.Absent) as raised:
        harness.metric(name)(training_run(spans=False))
    assert raised.value.source == span


def test_span_metrics_left_out_on_a_program_without_spans():
    """The parent's program has neither span: both metrics are left out,
    each with its line."""
    bench = harness.load_benchmark()
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] in ("optic_span_ms", "vjp_span_ms")]
    metrics, lines = harness.layer_metrics(bench, CELL, training_run(spans=False))
    assert metrics == {}
    assert lines == ["metric optic_span_ms: left out, the program has no dprox.optic",
                     "metric vjp_span_ms: left out, the program has no dprox.vjp"]
    metrics, lines = harness.layer_metrics(bench, CELL, training_run())
    assert set(metrics) == {"optic_span_ms", "vjp_span_ms"} and lines == []


@pytest.fixture
def cut_base(tmp_path):
    """A copy of portbench with the cell's traffic cut for the CPU."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("__pycache__"))
    (base / "traffic" / f"{CELL}.json").write_text(json.dumps(cut_traffic()))
    return base


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_cut_run_of_the_cell_on_the_cpu(cut_base, tmp_path, one_thread):
    """The cell at a 32 patch, a batch of 2 and 3 iterations: an untraced
    run reports the end-to-end metrics and checks the height map's
    gradient against the reference; a traced one records the optic's span
    (the CPU path runs no kernel Function, so no dprox.vjp)."""
    bench = harness.load_benchmark()
    result, lines = harness.run_cell(bench, CELL, 2 ** 33 + 11, 1.0, False, "cpu",
                                     time.perf_counter(), tmp_path / "t0", base=cut_base)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "images_per_s", "call_p95_ms"}
    assert result["checks"]["rms_rel_err"]["value"] <= 1e-4
    assert lines[-1].startswith("check answers compared: ")
    bench["per_layer"] = []
    result, _ = harness.run_cell(bench, CELL, 2 ** 33 + 12, 60.0, True, "cpu",
                                 time.perf_counter(), tmp_path / "t1", base=cut_base)
    assert result["correct"] is True and result["attempted"] == 3
    names = tr.Trace.load(tmp_path / "t1" / "trace.json").names
    assert "dprox.optic" in names and "dprox.xupdate" in names and "dprox.prox" in names

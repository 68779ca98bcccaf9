"""A per-layer metric may say that the program under test has no span or
counter of the name it reads (``harness.Absent``): the harness checks
that the run produced no such name anywhere, and then leaves the metric
out of the result line with a line on standard error. A name that the run
did produce, a metric of the device trace, and a metric that reads None
still fail the run. Also the span metrics' readers on a synthetic trace
whose answers are worked by hand."""
import importlib.util
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
CELL = "deconv_ffdnet.512"
RUN_CELL = harness.run_cell


def _x(cat, name, ts, dur, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def spanned_trace(spans=True):
    """Two calls of 2 ADMM iterations each over [0, 100) us. Host spans
    (``cpu_op``, as torch's fast record files them): dprox.prox [2, 20)
    with a nested dprox.prox [5, 10), dprox.xupdate [20, 35); dprox.prox
    [52, 70), dprox.xupdate [70, 90). Launches (runtime call at t,
    correlation id -> kernel on the device):

    3 (1) -> conv [10, 22); 6 (2) -> tv [22, 25); 21, cuLaunchKernel (3)
    -> fft [25, 29); 36, outside every span (4) -> elementwise [36, 38);
    53 (5) -> conv [55, 75); 71 (6) -> freq_divide [75, 76); 72 (7) ->
    fft [76, 80); 73, a memset (8) -> [80, 81), not a kernel.

    So the prior's kernels ran 12 + 3 + 20 us and the x-update's
    4 + 1 + 4 us, each counted once.
    """
    ev = [_x("user_annotation", tr.CALL_SPAN, 0, 40), _x("user_annotation", tr.CALL_SPAN, 50, 50),
          _x("cuda_runtime", "cudaLaunchKernel", 3, 1, 1),
          _x("cuda_runtime", "cudaLaunchKernel", 6, 1, 2),
          _x("cuda_driver", "cuLaunchKernel", 21, 1, 3),
          _x("cuda_runtime", "cudaLaunchKernel", 36, 1, 4),
          _x("cuda_runtime", "cudaLaunchKernel", 53, 1, 5),
          _x("cuda_runtime", "cudaLaunchKernel", 71, 1, 6),
          _x("cuda_runtime", "cudaLaunchKernel", 72, 1, 7),
          _x("cuda_runtime", "cudaMemsetAsync", 73, 1, 8),
          _x("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32", 10, 12, 1),
          _x("kernel", "void tv_denoise_chw_kernel<8, 12, false>(float const*)", 22, 3, 2),
          _x("kernel", "void regular_fft<256u>(float2*)", 25, 4, 3),
          _x("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 36, 2, 4),
          _x("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32", 55, 20, 5),
          _x("kernel", "void freq_divide_kernel<long>(float2 const*)", 75, 1, 6),
          _x("kernel", "void vector_fft<64u>(float2*)", 76, 4, 7),
          _x("gpu_memset", "Memset (Device)", 80, 1, 8),
          {"ph": "M", "name": "process_name", "args": {"name": "python"}}]
    if spans:
        ev += [_x("cpu_op", "dprox.prox", 2, 18), _x("cpu_op", "dprox.prox", 5, 5),
               _x("cpu_op", "dprox.xupdate", 20, 15), _x("cpu_op", "dprox.prox", 52, 18),
               _x("cpu_op", "dprox.xupdate", 70, 20)]
    return tr.Trace.from_chrome({"traceEvents": ev})


def spanned_run(spans=True, counter_names=frozenset()):
    t = spanned_trace(spans)
    lo, hi = t.window()
    return harness.TracedRun(trace=t, lo=lo, hi=hi, calls=2, iterations=2, images_per_call=1,
                             launches={}, counts={}, counter_names=frozenset(counter_names))


def test_span_lookup_whatever_the_category():
    t = spanned_trace()
    assert [(e.start, e.end) for e in t.ranges("dprox.prox")] == [(2, 20), (5, 10), (52, 70)]
    assert t.ranges(tr.CALL_SPAN) == t.calls()
    other = tr.Trace.from_chrome({"traceEvents": [_x("python_function", "dprox.prox", 1, 2)]})
    assert [(e.start, e.end) for e in other.ranges("dprox.prox")] == [(1, 3)]
    assert {"dprox.prox", "cudaMemsetAsync", "Memset (Device)", "process_name"} <= t.names
    assert tr.span_kernels(spanned_trace(spans=False), "dprox.prox", 0, 100) is None


def test_kernels_belong_to_the_span_that_launched_them():
    t = spanned_trace()
    prior = tr.span_kernels(t, "dprox.prox", 0, 100)
    assert sorted(k.correlation for k in prior) == [1, 2, 5]
    xupdate = tr.span_kernels(t, "dprox.xupdate", 0, 100)
    assert sorted(k.correlation for k in xupdate) == [3, 6, 7]
    # a span outside the stretch launches nothing into it
    assert sorted(k.correlation for k in tr.span_kernels(t, "dprox.prox", 50, 100)) == [5]


def test_span_readers_by_hand():
    run = spanned_run()
    # 4 iterations; the prior's kernels 35 us, the x-update's 9 us
    assert harness.metric("prior_span_ms")(run) == pytest.approx(35e-3 / 4)
    assert harness.metric("xupdate_span_ms")(run) == pytest.approx(9e-3 / 4)


@pytest.mark.parametrize("name,span", [("prior_span_ms", "dprox.prox"),
                                       ("xupdate_span_ms", "dprox.xupdate")])
def test_span_readers_say_absent_without_their_span(name, span):
    with pytest.raises(harness.Absent) as raised:
        harness.metric(name)(spanned_run(spans=False))
    assert raised.value.source == span


def test_span_readers_left_out_on_a_program_without_spans():
    """PR 20's situation: the parent's program has no such spans."""
    bench = harness.load_benchmark()
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] in ("prior_span_ms", "xupdate_span_ms")]
    metrics, lines = harness.layer_metrics(bench, CELL, spanned_run(spans=False))
    assert metrics == {}
    assert lines == ["metric prior_span_ms: left out, the program has no dprox.prox",
                     "metric xupdate_span_ms: left out, the program has no dprox.xupdate"]
    metrics, lines = harness.layer_metrics(bench, CELL, spanned_run())
    assert set(metrics) == {"prior_span_ms", "xupdate_span_ms"} and lines == []


READERS = {
    "says_nosuch": 'from portbench import harness\n\ndef read(run):\n'
                   '    raise harness.Absent("dprox.nosuch")\n',
    "says_xupdate": 'from portbench import harness\n\ndef read(run):\n'
                    '    raise harness.Absent("dprox.xupdate")\n',
    "says_counter": 'from portbench import harness\n\ndef read(run):\n'
                    '    raise harness.Absent("linalg.iterations")\n',
    "reads_none": "def read(run):\n    return None\n",
    "reads_calls": "def read(run):\n    return run.calls\n",
}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A copy of portbench with the test's readers beside its own, and the
    deconvolution's traffic cut for the CPU as test_portbench_faults.py
    cuts it."""
    base = tmp_path_factory.mktemp("pb") / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("__pycache__"))
    for name, text in READERS.items():
        (base / "metrics" / f"{name}.py").write_text(text)
    p = base / "traffic" / f"{CELL}.json"
    mix = json.loads(p.read_text())
    mix.update(size=32, iterations=3, pool=2, checked=4, warm_calls=1, trace_calls=2)
    p.write_text(json.dumps(mix))
    return base


def bench_with(*names, source="program_span"):
    """BENCHMARK.json with only the test's metrics, each listed for CELL."""
    b = harness.load_benchmark()
    b["per_layer"] = [{"name": n, "unit": "x", "better": "lower", "source": source,
                       "layer": "a test", "moves": "images_per_s", "workloads": [CELL]}
                      for n in names]
    return b


def test_absent_name_is_left_out(base):
    metrics, lines = harness.layer_metrics(bench_with("says_nosuch", "reads_calls"), CELL,
                                           spanned_run(), base)
    assert metrics == {"reads_calls": {"value": 2, "unit": "x"}}
    assert lines == ["metric says_nosuch: left out, the program has no dprox.nosuch"]


@pytest.mark.parametrize("name,counters", [("says_xupdate", ()),
                                           ("says_counter", ("linalg.iterations",))])
def test_a_name_the_run_produced_cannot_be_absent(base, name, counters):
    with pytest.raises(harness.MissingMetric, match="produced"):
        harness.layer_metrics(bench_with(name), CELL, spanned_run(counter_names=counters), base)


def test_a_device_trace_metric_cannot_be_absent(base):
    with pytest.raises(harness.MissingMetric, match="device_trace"):
        harness.layer_metrics(bench_with("says_nosuch", source="device_trace"), CELL,
                              spanned_run(), base)


def test_none_still_fails(base):
    with pytest.raises(harness.MissingMetric, match="reads_none"):
        harness.layer_metrics(bench_with("reads_none"), CELL, spanned_run(), base)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(base, tmp_path, bench):
    return harness.run_cell(bench, CELL, 2 ** 33 + 5, 0.3, True, "cpu", time.perf_counter(),
                            tmp_path / "trace", base=base)


def test_traced_run_leaves_out_what_the_program_lacks(base, tmp_path, one_thread):
    result, lines = traced(base, tmp_path, bench_with("says_nosuch", "reads_calls"))
    assert result["correct"] is True and list(result)[-1] == "checks"
    assert result["metrics"] == {"reads_calls": {"value": 2, "unit": "x"}}
    left = lines.index("metric says_nosuch: left out, the program has no dprox.nosuch")
    # the compared numbers stay the last lines
    assert all(line.startswith("check ") for line in lines[left + 1:])
    with pytest.raises(harness.MissingMetric, match="says_xupdate"):
        traced(base, tmp_path, bench_with("says_xupdate"))


def _run_py(monkeypatch, capsys, base, tmp_path, bench):
    """run.py's main on the CPU: its look for a card answered yes, the
    benchmark replaced by ``bench`` and the run made on the cut copy."""
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "unset")  # restored after the test; run.py sets them
    spec = importlib.util.spec_from_file_location("portbench_run", ROOT / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)
    monkeypatch.setattr(harness, "run_cell", lambda b, cell, seed, seconds, trace, device, t0,
                        trace_dir: RUN_CELL(b, cell, seed, seconds, trace, "cpu", t0,
                                            tmp_path / "trace", base=base))
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 33 + 7), "--seconds", "0.3",
                   "--trace", "1"])
    return rc, capsys.readouterr()


def test_run_py_exit_codes(monkeypatch, capsys, base, tmp_path, one_thread):
    rc, out = _run_py(monkeypatch, capsys, base, tmp_path, bench_with("says_nosuch"))
    assert rc == 0, out.err
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["metrics"] == {} and result["correct"] is True
    assert "metric says_nosuch: left out, the program has no dprox.nosuch" in out.err
    for name in ("says_xupdate", "reads_none"):
        rc, out = _run_py(monkeypatch, capsys, base, tmp_path, bench_with(name))
        assert rc == 4 and out.out.strip() == "", name
        assert name in out.err

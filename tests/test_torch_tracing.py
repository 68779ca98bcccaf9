"""The port's spans and counters (dprox_tpu_torch/utils/profiling.py): off
and free with no profiler running; under one, a ``dprox.prox`` and a
``dprox.xupdate`` range an ADMM iteration in the Chrome trace and in
``span_records()``, which each ``trace`` starts afresh; the solvers'
``linalg.solves`` / ``linalg.iterations`` counters against the matvecs a
solve makes.

Imports neither JAX nor the JAX package; on the card:
    python -m pytest --noconftest tests/test_torch_tracing.py
"""
import json

import numpy as np
import pytest
import torch

import dprox_tpu_torch as dp
from dprox_tpu_torch.linalg import solvers
from dprox_tpu_torch.utils import profiling

ITERS = 3


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset_spans()
    profiling.reset_counts()
    yield
    profiling.reset_spans()


def _problem(kind, device="cpu"):
    """A 1x3x24x24 deconvolution with a norm2 prior: its x-update divides in
    frequency ("deconv") or, behind a Bayer mosaic, runs preconditioned
    CG ("cg"). Returns the compiled solver and its observation."""
    rng = np.random.RandomState(0)
    psf = np.ones((5, 5), np.float32) / 25
    b = torch.from_numpy(rng.rand(1, 3, 24, 24).astype(np.float32)).to(device)
    x = dp.Variable()
    op = dp.conv(x, psf) if kind == "deconv" else dp.mosaic(dp.conv(x, psf))
    solver = dp.compile([dp.sum_squares(op - dp.Placeholder("b")), dp.norm2(x)], "admm",
                        device=device,
                        linear_solve_config=dp.LinearSolveConfig(max_iters=20, rtol=1e-4))
    return solver, b


def _solve(solver, b):
    return solver.solve(x0=b, rhos=0.1, lams=0.05, max_iter=ITERS, params={"b": b})


def _spd(n=24, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, n)
    m = torch.from_numpy(q @ q.T / n + np.eye(n)).float()
    b = torch.from_numpy(rng.randn(2, n)).float()
    return m, b


def test_span_is_one_shared_noop_without_a_profiler(monkeypatch):
    """No profiler: every span is the same object, and a solve opens no
    profiler range, creates no CUDA event and records nothing."""
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("dprox.prox") is profiling.span("dprox.xupdate")

    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for kind in ("deconv", "cg"):
        solver, b = _problem(kind)
        _solve(solver, b)
    assert profiling.span_records() == []
    assert profiling.counts()["linalg.solves"] == ITERS  # counters count all the same


@pytest.mark.parametrize("kind", ["deconv", "cg"])
def test_trace_writes_one_prox_and_one_xupdate_span_an_iteration(tmp_path, kind):
    solver, b = _problem(kind)
    _solve(solver, b)  # warm
    with profiling.trace(str(tmp_path)):
        _solve(solver, b)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert spans.count("dprox.prox") == ITERS and spans.count("dprox.xupdate") == ITERS

    records = profiling.span_records()
    assert [r["name"] for r in records] == ["dprox.xupdate", "dprox.prox"] * ITERS
    assert all(r["depth"] == 0 and r["host_ms"] > 0 for r in records)
    assert all(set(r) == {"name", "depth", "host_ms", "counts"} for r in records)
    moved = [r["counts"] for r in records if r["name"] == "dprox.xupdate"]
    if kind == "cg":
        assert all(c["linalg.solves"] == 1 and c["linalg.iterations"] >= 1 for c in moved)
    else:
        assert moved == [{}] * ITERS
    assert not any(r["counts"] for r in records if r["name"] == "dprox.prox")


def test_each_trace_starts_its_records_afresh(tmp_path):
    """Two profiled blocks in a row: the second's records are its own."""
    solver, b = _problem("deconv")
    with profiling.trace(str(tmp_path / "one")):
        _solve(solver, b)
    assert len(profiling.span_records()) == 2 * ITERS
    with profiling.trace(str(tmp_path / "two")):
        solver.solve(x0=b, rhos=0.1, lams=0.05, max_iter=1, params={"b": b})
    assert [r["name"] for r in profiling.span_records()] == ["dprox.xupdate", "dprox.prox"]


def test_nested_spans_have_depth_and_counter_deltas():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("dprox.xupdate"):
            profiling.count("linalg.iterations", 2)
            with profiling.span("dprox.prox"):
                profiling.count("linalg.iterations")
                profiling.count("linalg.solves")
    outer, inner = profiling.span_records()
    assert (outer["name"], outer["depth"]) == ("dprox.xupdate", 0)
    assert (inner["name"], inner["depth"]) == ("dprox.prox", 1)
    assert outer["counts"] == {"linalg.iterations": 3, "linalg.solves": 1}
    assert inner["counts"] == {"linalg.iterations": 1, "linalg.solves": 1}
    assert outer["host_ms"] >= inner["host_ms"]
    assert profiling.span("dprox.prox") is profiling.span("dprox.xupdate")  # off again
    profiling.reset_spans()
    assert profiling.span_records() == []


def test_a_capped_pcg_solve_counts_its_cap():
    m, b = _spd()
    solvers.pcg(lambda v: v @ m, b, rtol=0.0, max_iters=4)
    assert profiling.counts() == {"linalg.solves": 1, "linalg.iterations": 4}
    profiling.reset_counts()
    assert profiling.counts() == {}


def _counting(A):
    calls = []

    def wrapped(v):
        calls.append(1)
        return A(v)
    return wrapped, calls


@pytest.mark.parametrize("name", ["cg", "cg2", "pcg", "cg_pallas"])
def test_an_early_stop_counts_k_for_k_plus_one_matvecs(name):
    m, b = _spd()
    A, calls = _counting(lambda v: v @ m)
    solvers.SOLVERS[name](A, b, rtol=1e-3, max_iters=100)
    k = profiling.counts()["linalg.iterations"]
    assert 1 <= k < 100 and len(calls) == k + 1
    assert profiling.counts()["linalg.solves"] == 1


def test_the_xupdate_record_carries_the_solve_count(monkeypatch):
    """The CG x-update's span holds the iterations its solve ran: k, for
    the k + 1 matvecs that the solver made (the solver's A, or the
    structured CG's ``gram_spectrum`` on this mosaic(conv(x)) problem)."""
    import importlib

    from dprox_tpu_torch.linalg import structured

    ss_module = importlib.import_module("dprox_tpu_torch.proxfn.sum_squares")
    solver, b = _problem("cg")
    matvecs = []

    def counted(run):
        def wrapped(A, b_, **kwargs):
            A, calls = _counting(A)
            matvecs.append(calls)
            return run(A, b_, **kwargs)
        return wrapped

    for name in ("cg", "pcg"):
        monkeypatch.setitem(solvers.SOLVERS, name, counted(solvers.SOLVERS[name]))
    structured_solve, gram = ss_module.mosaic_conv_pcg, structured.gram_spectrum
    monkeypatch.setattr(ss_module, "mosaic_conv_pcg",
                        lambda *a, **kw: (matvecs.append([]), structured_solve(*a, **kw))[1])
    monkeypatch.setattr(structured, "gram_spectrum",
                        lambda *a: (matvecs[-1].append(1), gram(*a))[1])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        solver.solve(x0=b, rhos=0.1, lams=0.05, max_iter=1, params={"b": b})
    (xupdate,) = [r for r in profiling.span_records() if r["name"] == "dprox.xupdate"]
    (calls,) = matvecs
    k = xupdate["counts"]["linalg.iterations"]
    assert k >= 1 and len(calls) == k + 1
    assert xupdate["counts"]["linalg.solves"] == 1
    assert profiling.counts()["linalg.iterations"] == k


@pytest.mark.cuda
def test_the_profiler_gives_the_spans_device_time_on_the_card(tmp_path):
    """On the card the profiler attributes the kernels launched inside each
    span to it: both spans carry device time in ``key_averages()``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    solver, b = _problem("cg", device="cuda")
    _solve(solver, b)
    with profiling.trace(str(tmp_path)) as prof:
        _solve(solver, b)
    assert len(profiling.span_records()) == 2 * ITERS
    device_us = {}
    for row in prof.key_averages():
        if row.key in ("dprox.prox", "dprox.xupdate"):
            device_us[row.key] = device_us.get(row.key, 0.0) + row.device_time_total
    assert set(device_us) == {"dprox.prox", "dprox.xupdate"}
    assert all(us > 0 for us in device_us.values()), device_us

"""BENCHMARK.json and the files it names; a new configuration, traffic
mix and per-layer metric are added as new files and new entries alone."""
import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_benchmark()


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_every_name_has_its_file():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["limits"]
        assert all(v is not None for v in spec["limits"].values())
        assert set(c["reduced"]) == set(spec["reduced"])
        assert callable(harness.config(c["name"]).build)
    for w in b["workloads"]:
        mix = harness.traffic(w["name"])
        assert mix["config"] == w["config"] and w["chips"] in (1, 4)
        for key in ("size", "batch", "iterations", "schedule", "pool", "warm_calls", "checked",
                    "trace_calls"):
            assert key in mix, (w["name"], key)
    for m in b["per_layer"]:
        assert callable(harness.metric(m["name"]))


def test_a_new_config_traffic_and_metric_are_new_files(tmp_path):
    """A copy of portbench gains a configuration (a copy of deconv_ffdnet
    under a new name), a traffic mix at 32^2 and a metric, as new files
    and new BENCHMARK.json entries, with no edit to a file it had; the
    harness finds them and reports the metric in a traced run."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    for ext in ("py", "json"):
        text = (base / "configs" / f"deconv_ffdnet.{ext}").read_text()
        if ext == "py":
            text = text.replace('with_suffix(".json")', 'with_name("tiny_deconv.json")')
        else:
            text = text.replace('"name": "deconv_ffdnet"', '"name": "tiny_deconv"')
        (base / "configs" / f"tiny_deconv.{ext}").write_text(text)
    mix = harness.traffic("deconv_ffdnet.512")
    mix.update(config="tiny_deconv", size=32, iterations=2, pool=2, checked=2, warm_calls=1,
               trace_calls=2)
    (base / "traffic" / "tiny_deconv.32.json").write_text(json.dumps(mix))
    (base / "metrics" / "calls_traced.py").write_text("def read(run):\n    return run.calls\n")
    assert all(p.read_bytes() == data for p, data in before.items())

    b = bench()
    b["configs"].append({"name": "tiny_deconv", "source": "https://arxiv.org/abs/1710.04026",
                         "file": "portbench/configs/tiny_deconv.json", "reduced": ["num_layers"],
                         "why": "a test"})
    b["workloads"].append({"name": "tiny_deconv.32", "config": "tiny_deconv",
                           "traffic": "tiny_deconv.32", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "solver loop",
                           "moves": "images_per_s", "workloads": ["tiny_deconv.32"]})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # a traced run ends once its 2 calls are traced and its 2 answers
        # drawn, not at the window's 60 s
        t = time.perf_counter()
        result, _ = harness.run_cell(b, "tiny_deconv.32", 99, 60.0, True, "cpu",
                                     time.perf_counter(), tmp_path / "trace", base=base)
        assert time.perf_counter() - t < 50 and result["attempted"] == 3
        assert result["correct"] is True
        assert result["metrics"]["calls_traced"] == {"value": 2, "unit": "calls"}
        assert "images_per_s" not in result["metrics"]

        # a metric listed for the cell that reads nothing fails the run
        (base / "metrics" / "reads_nothing.py").write_text("def read(run):\n    return None\n")
        b["per_layer"].append(dict(b["per_layer"][-1], name="reads_nothing"))
        with pytest.raises(harness.MissingMetric, match="reads_nothing"):
            harness.run_cell(b, "tiny_deconv.32", 99, 0.2, True, "cpu", time.perf_counter(),
                             tmp_path / "trace", base=base)
    finally:
        torch.set_num_threads(n)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell_entry(bench(), "no_such_cell")

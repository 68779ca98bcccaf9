"""Nothing the benchmark loads is JAX or the JAX package, by whole
top-level names; without a card, or without the port beside it, the run
exits non-zero and prints no result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    names = ["dprox_tpu_torch", "dprox_tpu_torch.ops.kernels", "jaxtyping", "dprox_tpu_x",
             "dprox_tpu", "dprox_tpu.algo", "jax", "jax.numpy", "jaxlib.xla_client", "flax.core"]
    assert harness.leaked_modules(names) == ["dprox_tpu", "dprox_tpu.algo", "flax.core", "jax",
                                             "jax.numpy", "jaxlib.xla_client"]
    assert harness.leaked_modules(["dprox_tpu_torch", "torch"]) == []


def test_the_benchmark_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness, readings, workload, counts, trace\n"
            "from portbench.reference import ops, solvers\n"
            "b = harness.load_benchmark()\n"
            "for c in b['configs']: harness.config(c['name'])\n"
            "for m in b['per_layer']: harness.metric(m['name'])\n"
            "import dprox_tpu_torch\n"
            "print(harness.leaked_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "deconv_ffdnet.512",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_non_zero():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_alone_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["portbench"]

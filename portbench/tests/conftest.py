"""pytest settings of the benchmark's own tests (run them with
``python -m pytest portbench/tests`` from the root of the repository)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")

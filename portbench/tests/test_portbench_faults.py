"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (``run_cell`` on the CPU, the
port's plain versions of its kernels) and each fault these cells can
have is planted in turn: an ADMM step that returns its state unchanged,
and an answer altered where the timed path produces it. The cells hold
one image a call on one chip, so there is no batch to halve and no
exchange between chips to leave out."""
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from dprox_tpu_torch.algo.admm import ADMM
from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("deconv_ffdnet.512", "jdd_ffdnet.2048")


#: each cell's traffic cut for the CPU: the deconvolution to 32^2 and 3
#: iterations; the joint solve keeps its 5 iterations, at 64^2
CUT = {"deconv_ffdnet.512": {"size": 32, "iterations": 3},
       "jdd_ffdnet.2048": {"size": 64}}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of portbench whose cells' traffic is cut by ``CUT``."""
    base = tmp_path_factory.mktemp("pb") / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("__pycache__"))
    for cell in CELLS:
        p = base / "traffic" / f"{cell}.json"
        mix = json.loads(p.read_text())
        mix.update(pool=2, checked=4, warm_calls=1, **CUT[cell])
        p.write_text(json.dumps(mix))
    return base


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(base, cell):
    result, lines = harness.run_cell(harness.load_benchmark(), cell, 2 ** 33 + 1, 0.3, False,
                                     "cpu", time.perf_counter(), base=base)
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small, cell):
    assert run(small, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_step_that_returns_its_state_unchanged(small, cell, monkeypatch):
    monkeypatch.setattr(ADMM, "_iter", lambda self, state, *args, **kw: state)
    assert run(small, cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_it_is_produced(small, cell, monkeypatch):
    original = ADMM.solve

    def altered(self, *args, **kw):
        out = original(self, *args, **kw).clone()
        out[..., 5, 7] += 1.0
        return out

    monkeypatch.setattr(ADMM, "solve", altered)
    assert run(small, cell)["correct"] is False

"""The lower-precision control comes out not correct, and the program
correct, at each cell's own size, on three seeds: the card's half of the
check that decides ``correct`` (portbench/readings.py prints the same
readings for a dozen seeds)."""
import pytest
import torch

from portbench import harness, readings

SEEDS = (2 ** 31 + 3, 2 ** 32 + 77, 5_000_000_011)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark()["workloads"]])
def test_control_fails_where_the_program_passes(card, cell):
    limits = harness.config(harness.cell_entry(harness.load_benchmark(), cell)["config"]).SPEC["limits"]
    # 8 images a seed, so that the test's run stays short
    for row in readings.readings(cell, SEEDS, pool=8):
        assert all(row["program"][n] <= v for n, v in limits.items()), row
        assert any(row["control"][n] > v for n, v in limits.items()), row

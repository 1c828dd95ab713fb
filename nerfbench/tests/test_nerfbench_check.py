"""The output check: the package agrees with the reference within each
cell's limits; the control (the reference in fp8 where the configuration
states bf16) fails them; a run with the timed path broken underneath
(a step that leaves its state unchanged, half the batch left out, a frame's
chunk altered) comes out not correct. On the CPU at tiny sizes; on a card
(marker ``cuda``) the control also at the cells' widths and a test size."""

import pytest
import torch

from nerfbench import readings, run, spec
from nerfbench.tests.conftest import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
FAULTS_OF_KIND = {"train": ("unchanged", "halfbatch"), "view": ("answer",)}
FAULTS = [(c, f) for c in CELLS
          for f in FAULTS_OF_KIND[spec.load_cell(c)["traffic"]["kind"]]]


def fails(cell, numbers):
    limits = spec.load_cell(cell)["limits"]
    return [k for k, limit in limits.items() if not numbers[k] <= limit]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_program_within_limits(cell, seed):
    numbers = readings.reading(cell, seed, "program", "cpu", tiny(cell))
    assert not fails(cell, numbers), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    numbers = readings.reading(cell, 11, "control", "cpu", tiny(cell))
    assert fails(cell, numbers), numbers


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault):
    ov = tiny(cell)
    tr = ov["traffic"]
    per_frame = -(-tr.get("height", 0) * tr.get("width", 0) // tr.get("chunk", 1))
    with readings.planted(fault, max(1, per_frame)):
        result = run.run_cell(cell, 2 ** 31 + 99, 0.3, False, "cpu", ov)
    assert result["correct"] is False, result["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    """The control at the cell's widths and samples on fewer rays and
    pixels (a train step of 1024 rays, 200x200 frames)."""
    ov = {"config": {"train": {"num_rays": 1024}},
          "traffic": {"height": 200, "width": 200, "frames": 8}}
    for seed in (1, 2, 3):
        numbers = readings.reading(cell, seed, "control", card, ov)
        assert fails(cell, numbers), numbers

"""The control of each cell, the reference computed in float8 in the
program's place, comes out not correct: on the card at the cell's own
size (three seeds; `cuda`, skipped without a card).  At tiny sizes on
the host the control's path runs and departs from the reference, where
the program in fp32 agrees with it exactly."""

import pytest
import torch

from portbench import calibrate
from portbench.harness import core
from portbench.tests.tiny import tiny_files

CELLS = [w["name"] for w in core.manifest()["workloads"]]
SEEDS = [2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's size")
    core.prepare_environment()
    limits = core.find_cell(cell)[3]
    for row in calibrate.calibrate(cell, "control", SEEDS, 0.0):
        assert any(row[k] > v for k, v in limits.items()), row


@pytest.mark.parametrize("cell", CELLS)
def test_control_departs_from_the_reference_tiny(cell):
    names = list(tiny_files(cell)[3])
    program = calibrate.calibrate(cell, "program", SEEDS[:1], 0.2, "cpu",
                                  files=tiny_files(cell))[0]
    control = calibrate.calibrate(cell, "control", SEEDS[:1], 0.2, "cpu",
                                  files=tiny_files(cell))[0]
    assert all(program[k] == 0.0 for k in names), program
    assert any(control[k] > 0.0 for k in names), control

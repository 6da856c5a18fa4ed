"""The check's control and faults: with the timed path broken underneath
(or the program in bfloat16 where the configuration states float32), a
run's ``correct`` comes out false; as configured it comes out true."""

import time

import pytest
import torch

from portbench_helpers import CELLS, tiny_spec
from portbench import faults, harness

SEED = 2**41 + 7


def _run(cell, dtype=None):
    return harness.run_cell(tiny_spec(cell), SEED, 0.0, False, "cpu",
                            time.perf_counter(), dtype)


@pytest.mark.parametrize("cell", CELLS)
def test_program_as_configured_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(cell):
    res = _run(cell, torch.bfloat16)
    assert res["correct"] is False
    assert res["checks"]["out"]["value"] > res["checks"]["out"]["limit"]


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, kind):
    with faults.planted(kind, SEED):
        res = _run(cell)
    assert res["correct"] is False, res["checks"]
    if kind == "frozen":
        assert res["checks"]["change"]["value"] == pytest.approx(1.0)

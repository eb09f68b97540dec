"""Runs of the tiny cells on the CPU, the harness's look for a card skipped:
the program passes its cell's limits, and the control (the reference one
precision step below the configuration's, in the program's place) and each
fault a cell can have, planted under the timed path, come out not correct.
The chip-sized control runs are ``benchmark/control.py``."""

import time

import pytest

from harness import controls, runner, spec

CELLS = ("tiny.extract", "tiny.single", "tiny.bulk")


def _run(root: str, name: str, hook=None, seed: int = 2 ** 31 + 11) -> dict:
    cell = spec.load_cell(root, name)
    ctx = runner.Ctx(cell, seed, 1.0, False, "cpu", program_hook=hook)
    return runner.run_cell(ctx, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(tiny_root, name):
    res = _run(tiny_root, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny_root, name):
    res = _run(tiny_root, name, controls.control)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(tiny_root, name, fault):
    res = _run(tiny_root, name, controls.fault(fault))
    assert not res["correct"], res["checks"]

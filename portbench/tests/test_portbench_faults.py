"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, once for each fault a cell can have
(``core/faults.py``). One chip holds each cell, so no exchange between
chips can be left out. A step scaled by 1.3 is caught by ``step_error``
in the float64 cell and by ``step_loss`` in the df32 cells."""

import time

import pytest

from conftest import tiny_cell
from portbench.core import faults, session

CELLS = ["trafalgar257-df32-cholesky", "ladybug1723-df32-cholesky",
         "trafalgar257-f64-cholesky", "trafalgar257-df32-qrchol"]
SEED = 2 ** 31 + 99


def run(name):
    return session.run(tiny_cell(name), SEED, 0.5, False, "cpu", time.time())


@pytest.mark.parametrize("name", CELLS)
def test_clean_run_is_correct(name):
    res = run(name)
    assert res["verdict"]["correct"], res["verdict"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    undo = faults.plant(fault)
    try:
        res = run(name)
    finally:
        undo()
    assert not res["verdict"]["correct"], (fault, res["verdict"]["readings"])

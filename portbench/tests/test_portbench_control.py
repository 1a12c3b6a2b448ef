"""The control comes out not correct: the port's float32 path, the
nearest precision below each cell's, run as the program would be and held
to the cell's own comparison and limits.

On the CPU at a tiny size for the float64 cell; on the card at the cell's
own problem for the df32 cells, whose float32 control is told from the
program only at that size (tests marked ``cuda``)."""

import time

import pytest
import torch

from conftest import tiny_cell
from portbench.core import check, registry, session

SEEDS = [2 ** 31 + 104729 + 7919 * i for i in range(3)]


def test_float64_cell_control_fails_on_the_cpu():
    cell = tiny_cell("trafalgar257-f64-cholesky")
    assert session.run(cell, SEEDS[0], 0.5, False, "cpu", time.time())["verdict"]["correct"]
    for seed in SEEDS:
        res = session.run(cell, seed, 0.5, False, "cpu", time.time(), control="float32")
        assert not res["verdict"]["correct"], res["verdict"]["readings"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trafalgar257-df32-cholesky"])
def test_df32_cell_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = registry.cell(registry.load_benchmark(), name)
    raw = session.raw_arrays(cell.config)
    dev = torch.device("cuda", 0)
    prog = session.Program(cell, raw, dev, control="float32")
    runs = []
    for seed in SEEDS:
        win = prog.window(seed, 10.0)
        j = check.draw(seed, len(win.solves), "follow")
        runs.append((seed, win, j, prog.follow(seed, j, session.FOLLOW_ITERATIONS)))
    tol = prog.cfg.tol_fun
    prog.close()
    for seed, win, j, steps in runs:
        v = session.judge(cell, raw, seed, win, j, steps, tol, 0, dev)
        assert not v["correct"], v["readings"]

"""Shared pieces of the benchmark's own tests: a tiny stand-in of each
cell, run on the CPU (or on the card, for tests marked ``cuda``)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: A tiny stand-in of the cells' problems: the frozen generator at a size
#: a CPU test holds, with enough observations (~12,000) that one whose
#: robust loss a df32 run and float64 see on either side of the inlier
#: threshold (a quarter of tau^2 in an energy of ~150) stays inside the
#: cells' end-energy limit.
TINY = {"name": "tiny", "n_cameras": 24, "n_points": 3000, "inlier_threshold": 0.5,
        "data": {"kind": "balgen", "seed": 7, "mean_degree": 4.0},
        "assumed": {"start_perturbation": {"points": 3.5e-5, "translation": 1.2e-5}}}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json with the tiny problem in place of
    its configuration's: its traffic, its limits, its trace plan."""
    from portbench.core import registry

    cell = registry.cell(registry.load_benchmark(), name)
    cell.config = dict(TINY)
    return cell

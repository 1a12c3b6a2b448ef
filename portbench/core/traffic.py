"""The one generator of the benchmark's traffic: a closed loop of one
client that solves the configuration's problem again and again, each solve
from its own start point.

A traffic file (``portbench/traffic/<name>.json``) holds the solve's
parameters: the LM mode, the drive's precision (``geometry``: ``df32`` or
``f64``) and ``max_iter``. The cell's file holds the size of its pool of
starts (``start_pool``), sized to what its window solves. The
configuration's ``assumed.start_perturbation`` holds the start points'
scales. A start is
the configuration's initial state with every point coordinate moved by
``points`` x N(0, 1) and every camera translation by ``translation`` x
N(0, 1), drawn on the device by a generator seeded from a pair (s, k).

Every run solves the same pool of ``start_pool`` starts, k = 0 .. P-1 of
``POOL_SEED``, in an order that ``--seed`` draws, and again in the same
order when the window outlasts the pool: so every seed
gives the window the same work in another order, and the same seed the
same starts.
"""

from __future__ import annotations

import hashlib
import random

import torch

#: The seed of every cell's pool of starts.
POOL_SEED = 2026


def start_key(spec: dict, seed: int, i: int) -> tuple:
    """(pool seed, k): the start of solve ``i`` of a run seeded ``seed``;
    ``spec`` is the cell's file."""
    pool = int(spec["start_pool"])
    order = random.Random(f"portbench-order:{int(seed)}").sample(range(pool), pool)
    return POOL_SEED, order[i % pool]


def start_seed(seed: int, i: int) -> int:
    """The generator seed of start ``i`` of a run seeded ``seed``."""
    digest = hashlib.sha256(f"portbench-start:{int(seed)}:{int(i)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def start_deltas(seed: int, i: int, n_cameras: int, n_points: int,
                 scales: dict, device) -> tuple:
    """(dT (N,3), dX (M,3)) float64 of start ``i``, drawn on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(start_seed(seed, i))
    f64 = torch.float64
    dX = torch.randn((n_points, 3), generator=gen, dtype=f64, device=device)
    dT = torch.randn((n_cameras, 3), generator=gen, dtype=f64, device=device)
    return dT * float(scales["translation"]), dX * float(scales["points"])

"""torch's intra-op thread pool sized to the pytest-xdist worker.

Every ``tests/test_torch_*.py`` imports this module before its first torch
work. Under ``pytest -n W`` each worker is a process of its own, and a torch
that spins one thread per CPU in each of them puts W times as many threads
as there are cores on the machine: the port's CPU runs then take many times
longer than alone. At import this module

- sizes the pool to ``max(2, cpus // W)`` (W is 1 without xdist, so a
  serial run keeps the machine's count), lowered to ``OMP_NUM_THREADS``
  where the caller set it, never below 2;
- exports ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` with that count,
  unless the caller set them, so the processes a test starts (the
  command line, the bench script, the ranks of ``multihost.run_ranks``)
  inherit the cap.

The floor of 2: at 1 thread torch reduces in another order, and p16's
float64 default run parts from JAX's at iteration 6
(``test_torch_jit_drive.py::test_default_config_matches_jax_default_on_p16``
was measured at 2 to 8 threads). It imports nothing of JAX; the parse of
``OMP_NUM_THREADS`` is the one ``multihost`` applies to its spawned ranks.
"""

import os

import torch

from bundleadjustment_benchmarks_tpu_torch.parallel.multihost import _inherited_threads

#: The fewest intra-op threads a port test runs with.
FLOOR = 2

#: The variables a started process reads its thread count from.
EXPORTED = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


def _cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity outside Linux
        return os.cpu_count() or 1


def threads_for(environ, cpus: int) -> int:
    """The pool size for a process with ``environ`` on ``cpus`` CPUs."""
    workers = max(1, int(environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    k = cpus // workers
    return max(FLOOR, min(k, _inherited_threads(environ) or k))


#: The caller's ``OMP_NUM_THREADS`` (0 where it set none).
INHERITED = _inherited_threads(os.environ)
THREADS = threads_for(os.environ, _cpus())
torch.set_num_threads(THREADS)
for _name in EXPORTED:
    os.environ.setdefault(_name, str(THREADS))

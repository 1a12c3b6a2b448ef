"""The device's idle share inside the replayed LM graph: over each traced
solve's graph extent (its first ``prepare`` begin mark to its last
``trial`` end mark), 100 x the time no device operation runs, over the
extents' time. The gaps between kernels, at the graph's conditional
nodes and between slots; ``device_idle_pct`` less this share is the idle
time outside the graph (the host's set-up, replay launch and read). None
where the trace is incomplete or holds another count of spans than the
port counted (``core/marks.py``)."""

from portbench.core import marks, trace

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "device graph (ops/cuda_graph.py)"
MOVES = "lm_iters_per_s"


def read(run):
    got = marks.spans(run)
    if not got:
        return None
    extents = marks.solve_extents(run, got)
    total = sum(b - a for a, b in extents)
    if total <= 0:
        return None
    ops = [(a, b) for _, a, b in marks.in_window(run)]
    busy = sum(trace.union(ops, a, b)[0] for a, b in extents)
    return 100.0 * (1.0 - busy / total)

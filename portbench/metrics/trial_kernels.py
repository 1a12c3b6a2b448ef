"""Device operations a damped trial runs: the operations, marks excluded,
that start inside the port's ``trial`` spans, over the trials. What a
fusion of the trial's small kernels takes away. None where the trace is
incomplete or holds another count of spans than the port counted
(``core/marks.py``)."""

import bisect

from portbench.core import marks

UNIT = "ops/trial"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "damped trial (solvers/lm.py _trial, _trial_fast: solve_damped, point factor, camera solve, trial energy)"
MOVES = "lm_iters_per_s"


def read(run):
    got = marks.spans(run)
    if not got or not got["trial"]:
        return None
    starts = [a for name, a, _ in marks.in_window(run) if name not in marks.NAMES]
    inside = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
                 for a, b in got["trial"])
    return inside / len(got["trial"])

"""The damped trial's mean device time: the port's ``trial`` spans (its
in-graph marks around the trial in ``lm.DeviceLoop._step``: the damped
solve, the point factor, the reduced camera solve, the step and the trial
energy; the LM decision after it is outside) over the traced solves. None
where the trace is incomplete or holds another count of spans than the
port counted (``core/marks.py``)."""

from portbench.core import marks

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "damped trial (solvers/lm.py _trial, _trial_fast: solve_damped, point factor, camera solve, trial energy)"
MOVES = "lm_iters_per_s"


def read(run):
    return marks.mean_ms(run, "trial")

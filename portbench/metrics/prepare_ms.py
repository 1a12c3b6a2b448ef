"""The LM prepare's mean device time: the port's ``prepare`` spans (its
in-graph marks around ``lm.DeviceLoop._begin``: the residuals, Jacobian and
energy, the Schur context, the iteration's start) over the traced solves.
None where the trace is incomplete or holds another count of spans than
the port counted (``core/marks.py``)."""

from portbench.core import marks

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "LM prepare (solvers/lm.py _prepare, _prepare_fast; schur.build_context)"
MOVES = "lm_iters_per_s"


def read(run):
    return marks.mean_ms(run, "prepare")

"""The float32 camera solve's QR fallbacks per damped trial: the port's
fallback marks (one each time the float32 Cholesky of the reduced system
breaks down and the QR branch runs, ``schur._camera_solve_chol``) over the
trials of the traced solves. None where the trace is incomplete or holds
another count of spans than the port counted (``core/marks.py``)."""

from portbench.core import marks

UNIT = "fallbacks/trial"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "Schur solve (solvers/schur.py, the reduced camera solve)"
MOVES = "lm_iters_per_s"


def read(run):
    got = marks.spans(run)
    if not got or not got["trial"]:
        return None
    return marks.count(run, marks.FALLBACK) / len(got["trial"])

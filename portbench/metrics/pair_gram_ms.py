"""The weighted observation-pair gram's mean device time: the port's
``pair_gram`` spans (its in-graph marks around ``schur._pair_gram_cached``
and ``schur.qrkit_pair_trial_sums``: the weights' gather, the pair
products, the per-camera diagonal blocks, the sums per camera key and
their placement in the dense (9N, 9N) sum), one a trial, over the traced
solves. None where the trace is incomplete or holds another count of
spans than the trials the port counted, and so from a program without
these marks.

The span's mark names are kept here: ``core/marks.py`` names the spans
the benchmark read first, and is not edited."""

from portbench.core import marks

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "pair gram (solvers/schur.py _pair_gram_tables: the weighted observation-pair gram of each trial)"
MOVES = "lm_iters_per_s"

#: The span's begin and end mark kernels, as the profiler names them.
BEGIN, END = "ba_mark_pair_gram_begin", "ba_mark_pair_gram_end"


def spans(run):
    """(start, end) of each pair gram of the traced solves, in order, or
    None unless there is one for every trial the port counted."""
    if run.trace is None or not run.trace_complete or not run.traced:
        return None
    found = marks.pair(marks.in_window(run), BEGIN, END)
    if not found or len(found) != sum(s["slots"] for s in run.traced):
        return None
    return found


def read(run):
    got = spans(run)
    if got is None:
        return None
    return sum(b - a for a, b in got) / len(got) / 1e6

"""The port's in-graph marks as a traced run shows them: one-thread kernels
that the port's LM drive runs at the ends of its prepares, its damped
trials and its reduced camera solves (``ops/csrc/graph_cond.cu``), and one
at each QR fallback of the float32 camera solve. A span runs from its
begin mark's start to its end mark's end.

The mark kernels' names are kept here, not imported: the harness imports
the port in ``core/session.py`` only. A run holds its spans where its
trace is complete and holds, of each span, as many as the port counted in
the traced solves (``LAST_JIT_RUN``'s ``prepares`` for a prepare,
``slots`` for a trial and for a camera solve); else the readers read
nothing. A program without marks so reads nothing, and a trace that lost
a mark is caught where no chain kernel runs (the float64 drive).
"""

from __future__ import annotations

#: (begin, end) mark kernels of each span, as the profiler names them.
SPANS = {
    "prepare": ("ba_mark_prepare_begin", "ba_mark_prepare_end"),
    "trial": ("ba_mark_trial_begin", "ba_mark_trial_end"),
    "camera_solve": ("ba_mark_camera_solve_begin", "ba_mark_camera_solve_end"),
}
#: The camera solve's QR-fallback mark.
FALLBACK = "ba_mark_camera_fallback"
NAMES = frozenset(n for pair in SPANS.values() for n in pair) | {FALLBACK}
#: The key of a traced solve's record whose sum counts each span.
COUNTED_BY = {"prepare": "prepares", "trial": "slots", "camera_solve": "slots"}


def in_window(run) -> list:
    """The traced window's device operations, (name, start, end), by start."""
    lo, hi = run.trace.window
    return sorted((op for op in run.trace.ops if op[2] > lo and op[1] < hi),
                  key=lambda op: op[1])


def pair(ops, begin: str, end: str) -> list:
    """(start, end) of each span that ``ops`` (by start) hold: a begin mark
    paired with the next end mark. A begin mark with no end before the next
    begin, or an end with no begin, is dropped (the counts then differ)."""
    out, open_at = [], None
    for name, a, b in ops:
        if name == begin:
            open_at = a
        elif name == end and open_at is not None:
            out.append((open_at, b))
            open_at = None
    return out


def spans(run):
    """{span: [(start, end), ...] in order} over the traced solves, or None
    where the trace is incomplete or a span's count is not the port's."""
    if run.trace is None or not run.trace_complete or not run.traced:
        return None
    ops = in_window(run)
    out = {}
    for span, (begin, end) in SPANS.items():
        found = pair(ops, begin, end)
        if len(found) != sum(s[COUNTED_BY[span]] for s in run.traced):
            return None
        out[span] = found
    return out


def mean_ms(run, span: str):
    """The mean length (ms) of ``span``, or None."""
    got = spans(run)
    if not got or not got[span]:
        return None
    return sum(b - a for a, b in got[span]) / len(got[span]) / 1e6


def count(run, name: str) -> int:
    """How many device operations named ``name`` the traced window holds."""
    lo, hi = run.trace.window
    return sum(1 for op in run.trace.ops if op[0] == name and op[2] > lo and op[1] < hi)


def solve_extents(run, got) -> list:
    """(start, end) of each traced solve's graph: its first prepare's begin
    to its last trial's end, the spans split by the port's counts of each
    solve in order."""
    out, p, t = [], 0, 0
    for solve in run.traced:
        n_p, n_t = solve["prepares"], solve["slots"]
        if n_p and n_t:
            out.append((got["prepare"][p][0], got["trial"][t + n_t - 1][1]))
        p, t = p + n_p, t + n_t
    return out

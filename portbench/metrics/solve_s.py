"""Seconds per solve: the window's seconds over the solves it completed,
each from its start to its stop. Reported where the stop does not depend
on rounding (the float64 drive flatlines)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return run.window_s / len(run.solves)

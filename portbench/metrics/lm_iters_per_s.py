"""LM iterations per second: the iterations of every solve completed in
the window over the window's seconds (bench.py's rate, and the reference
binaries')."""

UNIT = "iter/s"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return sum(s["iterations"] for s in run.solves) / run.window_s

"""Set-up seconds: from the process's start to the window's start (the
imports, the problem's load or generation, the port's problem and tables,
the warm-up solve with its graph capture, and on a checkout's first run
the build of the port's kernels)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return run.setup_s

"""The device's idle share over the traced solves: 100 x (1 - the union of
the device operations' intervals / the traced solves' wall time). The
gaps between solves count. None where the trace holds fewer chain
launches than the port counted (``session.start_profiler``)."""

from portbench.core import trace

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device (H100)"
MOVES = "lm_iters_per_s"


def read(run):
    if run.trace is None or not run.trace_complete:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / run.trace.window_s)

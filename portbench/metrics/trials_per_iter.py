"""Damping trials per LM iteration over the traced solves: the port's
``LAST_JIT_RUN["slots"]`` over its ``prepares``, summed. A waste ratio:
every rejected trial is paid for."""

UNIT = "trials/iter"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "LM driver (solvers/lm.py, DeviceLoop)"
MOVES = "lm_iters_per_s"


def read(run):
    prepares = sum(s["prepares"] for s in run.traced)
    if not prepares:
        return None
    return sum(s["slots"] for s in run.traced) / prepares

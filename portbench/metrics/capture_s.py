"""Seconds of the set-up solve's CUDA graph capture, as the port times it
(``LAST_JIT_RUN["capture_s"]``; its eager warm-up before the capture is
left out)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "device graph (ops/cuda_graph.py)"
MOVES = "setup_s"


def read(run):
    return run.capture_s if run.capture_s > 0 else None

"""The most device memory the process holds: total minus free from
``torch.cuda.mem_get_info``, sampled after set-up and after the window
(graph pools, library workspaces and the CUDA context included)."""

UNIT = "GiB"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = None
MOVES = None


def read(run):
    return max(run.mem_bytes) / 2 ** 30

"""The chain kernels' share of their roofline: the frozen least time of
each launch (``core/roofline.kernel_bounds``: each input byte read once,
each output byte written once, and the frozen operation count, against the
card's published peaks), summed over the launches in the traced solves,
over the device time of those launches. None where the trace holds fewer
chain launches than the port counted."""

from portbench.core import roofline, trace

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "chain (ops/cuda_chain.py, ops/csrc/chain_kernels.cu)"
MOVES = "lm_iters_per_s"
#: Kernel names as the profiler shows them on the card, one per kernel.
KERNELS = {"chain_blocks": "chain_blocks_kernel",
           "chain_energy": "chain_energy_kernel"}


def read(run):
    if run.trace is None or not run.trace_complete:
        return None
    found = {which: trace.kernel_time_s(run.trace, (name,))
             for which, name in KERNELS.items()}
    spent = sum(secs for secs, _ in found.values())
    if spent <= 0:
        return None
    bw, fp32 = roofline.card_rates(run.card)
    bounds = roofline.kernel_bounds(*run.sizes, bw, fp32 / 2)
    least = sum(bounds[which][0] / 1e3 * launches
                for which, (_, launches) in found.items())
    return 100.0 * least / spent

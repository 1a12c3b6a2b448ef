"""The reduced camera solve's share of its roofline: per damping trial the
least work of factoring and solving the reduced system of size n = 9 N,
n^3/3 + 2 n^2 flops (``core/roofline.camera_solve_flops``), at the card's
published peak (67 TFLOP/s on the H100 SXM: float32 outside the tensor
cores, and FP64 on them), times the trials of the traced solves, over the
device time of the kernels named below: the factorization and
triangular-solve kernels of cuSOLVER and cuBLAS, whose names nothing else
on the path shares (the blocked updates' GEMMs, which other layers share,
are left out, so the share reads high rather than low). None where the
trace holds fewer chain launches than the port counted."""

from portbench.core import roofline, trace

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Schur solve (solvers/schur.py, the reduced camera solve)"
MOVES = "lm_iters_per_s"
#: Substrings of the camera solve's kernel names as the profiler shows
#: them on the card (H100 traces of p257 and the Ladybug stand-in): the
#: float64 QR of the scaled reduced system, geqr2_* and larft_*; the
#: float32 Cholesky's getrf_wo_pivot and syrk kernels and its QR fallback's
#: geqr2_*; the triangular solves, trsv_*; potrf and trsm where they run.
PATTERNS = ("geqr2", "larft", "trsv", "potrf", "getrf", "syrk", "trsm")


def read(run):
    if run.trace is None or not run.trace_complete:
        return None
    secs, launches = trace.kernel_time_s(run.trace, PATTERNS)
    trials = sum(s["slots"] for s in run.traced)
    if secs <= 0 or not trials:
        return None
    least = roofline.camera_solve_flops(run.sizes[0]) * trials \
        / roofline.camera_solve_peak(run.card)
    return 100.0 * least / secs

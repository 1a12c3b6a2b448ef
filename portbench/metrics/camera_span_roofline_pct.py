"""The reduced camera solve's share of its roofline, timed by the port's
``camera_solve`` spans (its in-graph marks around
``schur._camera_solve_chol``: the Jacobi scaling, the factor, the
refined solves and, where the float32 Cholesky breaks down, the QR
fallback): the least work of factoring and solving the reduced system of
size n = 9 N once, n^3/3 + 2 n^2 flops (``core/roofline``), at the card's
published peak, times the spans, over their summed time. Unlike
``camera_solve_roofline_pct`` it counts the solve's GEMMs and nothing of
another layer (qrchol's point QR). None where the trace is incomplete or
holds another count of spans than the port counted (``core/marks.py``)."""

from portbench.core import marks, roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "Schur solve (solvers/schur.py, the reduced camera solve)"
MOVES = "lm_iters_per_s"


def read(run):
    got = marks.spans(run)
    if not got or not got["camera_solve"]:
        return None
    spent = sum(b - a for a, b in got["camera_solve"]) / 1e9
    least = roofline.camera_solve_flops(run.sizes[0]) * len(got["camera_solve"]) \
        / roofline.camera_solve_peak(run.card)
    return 100.0 * least / spent

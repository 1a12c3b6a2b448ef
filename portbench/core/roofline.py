"""Published peaks and the least work of the kernels the benchmark reads,
frozen for the benchmark.

``CARDS``, ``OPS_PER_OBS`` and ``kernel_bounds`` are copied from
``chip_smoke.py`` at commit 306ffbcb20dbd48e32330260e2650eb0bfef3067. The
operation counts stay frozen as data: the yardstick counts the same work
whatever later implements the chain.
"""

from __future__ import annotations

#: Published device-memory rate (bytes/s) and float32 peak (FLOP/s, outside
#: the tensor cores, an FMA counted as two) by card name (NVIDIA data sheets).
CARDS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
)
#: The H100 SXM's FP64 tensor-core peak (FLOP/s, data sheet), equal to its
#: float32 peak outside the tensor cores: the camera solve's yardstick in
#: either precision.
CAMERA_SOLVE_PEAK = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H200": 67e12,
                     "H100": 67e12}
#: float32 instructions per observation of the two chain kernels (counted
#: from the port's csrc/chain_math.cuh at the commit above: the DF
#: transform 180, the residual 18, the robust factor 12; blocks then add
#: the Jacobian rows and the robust product (166) and the DF square sum
#: (15), energy adds its DF square (15); each adds one DF add into its
#: running sum (11)). Built without FMA contraction, they issue at half the
#: FMA-counting peak.
OPS_PER_OBS = {"chain_blocks": 180 + 18 + 12 + 166 + 15 + 11,
               "chain_energy": 180 + 18 + 12 + 15 + 11}


def card_rates(name: str) -> tuple:
    """(bytes/s, float32 FLOP/s) of a card by its name; KeyError if the
    table has no entry."""
    for key, bw, fp32 in CARDS:
        if key in name:
            return bw, fp32
    raise KeyError(f"no published rates for card {name!r}")


def camera_solve_peak(name: str) -> float:
    for key, _, _ in CARDS:
        if key in name:
            return CAMERA_SOLVE_PEAK[key]
    raise KeyError(f"no published rates for card {name!r}")


def kernel_bounds(n: int, m: int, k_obs: int, bw: float, op_rate: float) -> dict:
    """Per chain kernel (bound_ms, bound_by): each input read once, each
    output written once (the float64 cameras R, T, K(0, 0), k1, k2; the DF
    points, every point observed; the measurements and both indices; the
    energy, and the rows), and OPS_PER_OBS float32 instructions per
    observation at ``op_rate``."""
    inputs = 8 * 15 * n + 4 * (6 * m + 2 * k_obs + 2 * k_obs)
    out = {}
    for which, outputs in (("chain_blocks", 8 + 4 * 26 * k_obs),
                           ("chain_energy", 8)):
        t_bytes = (inputs + outputs) / bw * 1e3
        t_ops = OPS_PER_OBS[which] * k_obs / op_rate * 1e3
        out[which] = (max(t_bytes, t_ops),
                      "bytes" if t_bytes >= t_ops else "operations")
    return out


def camera_solve_flops(n_cameras: int) -> float:
    """Least work of factoring and solving the reduced camera system of
    size n = 9 N once: n^3/3 + 2 n^2."""
    n = 9 * n_cameras
    return n ** 3 / 3.0 + 2.0 * n ** 2

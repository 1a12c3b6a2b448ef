"""estimateNorm: the diagonally scaled state norm (reference BAFunctor.cpp:25-61).

    total = (sum over cameras of |T_i . diag_T| + |omega_i . diag_w|
             + |k12_i . diag_k| + |f_i diag_f|)^2 + ||points . diag_pts||^2
    return sqrt(total)

with omega the log map of the camera rotation (``rodrigues.log_rodrigues``,
the corrected quaternion read, as in the JAX package). ``diag`` has the
reference's points-first layout: [0, 3M) point coordinates, then
[3M, 3M + 9N) camera parameters T(3), omega(3), f, k1, k2.
"""

from __future__ import annotations

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import rodrigues


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def estimate_norm(state, diag: torch.Tensor) -> torch.Tensor:
    m, n = state.n_points, state.n_cameras
    diag_pts = diag[: 3 * m].reshape(m, 3)
    diag_cam = diag[3 * m:].reshape(n, 9)
    omega = rodrigues.log_rodrigues(state.R)
    k12 = torch.stack([state.k1, state.k2], dim=-1)
    per_cam = (_norm(state.T * diag_cam[:, 0:3])
               + _norm(omega * diag_cam[:, 3:6])
               + _norm(k12 * diag_cam[:, 7:9])
               + torch.abs(state.focal * diag_cam[:, 6]))
    total = per_cam.sum() ** 2 + ((state.points * diag_pts) ** 2).sum()
    return torch.sqrt(total)

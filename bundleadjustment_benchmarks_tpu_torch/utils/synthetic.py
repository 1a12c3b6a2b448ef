"""Synthetic BA problem generator (tests, dry runs, scaling).

A random multi-view problem with BAL conventions (negative focal,
pre-scaled distortion; reference bundle_adjustment_large.cpp:88-98): ground
truth is projected, then the measurements and points are perturbed, so LM
has a basin to descend. The numpy draws are the JAX package's
(``utils/synthetic.py``) in the same order, so a seed gives the same arrays
in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_benchmarks_tpu_torch.io.bal import BalDataset
from bundleadjustment_benchmarks_tpu_torch.models.problem import (
    BAProblem, from_bal_dataset)


def make_synthetic_problem(
    n_cameras: int = 4,
    n_points: int = 12,
    obs_per_point: int = 3,
    seed: int = 0,
    noise: float = 5e-3,
    dtype=torch.float64,
    inlier_threshold: float = 0.5,
    mixed_degree: bool = False,
    device=None,
) -> BAProblem:
    """The problem on ``device`` (CUDA unless the caller names one).

    ``mixed_degree=True`` keeps only the first observation of every
    even-indexed point: the problem has points seen once (rank-2 point
    blocks) and points seen several times (so pair tables exist).

    At the default inlier threshold, 0.5 px, many observations start
    truncated (the 1e-3 point perturbation moves them ~f 1e-3 / z px), so
    the energy is a ladder of plateaus tau^2/4 apart and which one LM lands
    on follows rounding noise; runs that compare endpoints pass 2.0."""
    rng = np.random.default_rng(seed)
    omega = rng.normal(scale=0.1, size=(n_cameras, 3))
    translation = rng.normal(scale=0.2, size=(n_cameras, 3))
    translation[:, 2] += 2.0  # points end up at positive depth
    focal = rng.uniform(400.0, 600.0, size=n_cameras)
    k1 = rng.normal(scale=1e-8, size=n_cameras)
    k2 = rng.normal(scale=1e-14, size=n_cameras)
    points = rng.normal(scale=0.5, size=(n_points, 3))

    # Each point is seen by `obs_per_point` distinct random cameras:
    # row-wise first-L of a random permutation per point.
    L = min(obs_per_point, n_cameras)
    cam_choice = np.argsort(
        rng.random((n_points, n_cameras)), axis=1
    )[:, :L].astype(np.int32)
    cam_idx = cam_choice.reshape(-1)
    pt_idx = np.repeat(np.arange(n_points, dtype=np.int32), L)

    # Rodrigues (vectorized, f64).
    theta = np.linalg.norm(omega, axis=-1, keepdims=True)
    safe = np.where(theta > 0, theta, 1.0)
    k = omega / safe
    Kx = np.zeros((n_cameras, 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2] = -k[:, 2], k[:, 1]
    Kx[:, 1, 0], Kx[:, 1, 2] = k[:, 2], -k[:, 0]
    Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 1], k[:, 0]
    st, ct = np.sin(theta)[..., None], np.cos(theta)[..., None]
    R = np.eye(3) + st * Kx + (1 - ct) * np.einsum("nij,njk->nik", Kx, Kx)

    # Resample points that land at (or behind) a viewing camera's plane:
    # z ~ 0 projections make the synthetic energy inf/NaN (observed at the
    # 18060-point scale with seed 0). Real BAL data has no such points.
    for _ in range(100):
        z = (
            np.einsum("kj,kj->k", R[cam_idx][:, 2, :], points[pt_idx])
            + translation[cam_idx][:, 2]
        )
        bad = np.unique(pt_idx[z < 0.2])
        if bad.size == 0:
            break
        points[bad] = rng.normal(scale=0.5, size=(bad.size, 3))

    XX = (
        np.einsum("kij,kj->ki", R[cam_idx], points[pt_idx])
        + translation[cam_idx]
    )
    xu = XX[:, :2] / XX[:, 2:3]
    r2 = np.sum(xu * xu, axis=1)
    pk1 = (k1 * focal**2)[cam_idx]
    pk2 = (k2 * focal**4)[cam_idx]
    kr = 1 + pk1 * r2 + pk2 * r2 * r2
    meas = (-focal[cam_idx] * kr)[:, None] * xu
    meas = meas + rng.normal(scale=noise, size=meas.shape)

    if mixed_degree:
        slot = np.tile(np.arange(L, dtype=np.int32), n_points)
        keep = (pt_idx % 2 != 0) | (slot == 0)
        cam_idx, pt_idx, meas = cam_idx[keep], pt_idx[keep], meas[keep]

    ds = BalDataset(
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        measurements=meas,
        omega=omega,
        translation=translation,
        focal=focal,
        k1=k1,
        k2=k2,
        points=points + rng.normal(scale=1e-3, size=points.shape),
    )
    return from_bal_dataset(ds, dtype=dtype, inlier_threshold=inlier_threshold,
                            device=device)

"""Reprojection-error statistics and the "true objective" printouts.

The reference's Utils.h:15-68, with its printed lines:

    Mean reprojection error: <value>
    Inlier mean reprojection error: <value> (<nInliers> / <K> inliers)
    True objective: <value>

Kept quirk: showObjective passes the residual NORM, not its square, as the
``r2`` of the cubic kernel (Utils.h:61-62). Kept guard: with no inlier the
inlier mean is 0, where the reference divides by zero (Utils.h:38).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import projection, robust


class ErrorStats(NamedTuple):
    mean_reprojection_error: torch.Tensor
    inlier_mean_reprojection_error: torch.Tensor
    n_inliers: torch.Tensor
    n_observations: int


def _project(state, obs) -> torch.Tensor:
    ci = obs.cam_idx
    return projection.project_affine(state.K[ci], state.R[ci], state.T[ci],
                                     state.k1[ci], state.k2[ci],
                                     state.points[obs.pt_idx])


def _norm(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d * d).sum(-1))


def error_statistics(state, obs, avg_focal_length,
                     inlier_threshold) -> ErrorStats:
    """Mean and inlier-mean reprojection error (Utils.h:15-43), as 0-dim
    tensors on the state's device."""
    err = _norm(avg_focal_length * (_project(state, obs) - obs.measurements))
    inlier = err <= inlier_threshold
    n_inl = inlier.sum()
    inl_mean = torch.where(
        n_inl > 0,
        torch.where(inlier, err, torch.zeros_like(err)).sum()
        / torch.clamp(n_inl, min=1),
        torch.zeros((), dtype=err.dtype, device=err.device))
    return ErrorStats(err.mean(), inl_mean, n_inl, obs.n_observations)


def true_objective(state, obs, avg_focal_length,
                   inlier_threshold) -> torch.Tensor:
    """The sum of the cubic-kernel costs (Utils::showObjective)."""
    p = _project(state, obs)
    r2 = _norm((avg_focal_length * avg_focal_length) * (p - obs.measurements))
    tau2 = torch.tensor(inlier_threshold * inlier_threshold, dtype=p.dtype,
                        device=p.device)
    return robust.psi_cubic(tau2, r2).sum()


def show_error_statistics(state, obs, avg_focal_length,
                          inlier_threshold) -> float:
    """Print the reference's two statistics lines (one host read); returns
    the inlier ratio (Utils.h:42)."""
    s = error_statistics(state, obs, avg_focal_length, inlier_threshold)
    mean, inl, n_inl = torch.stack([
        t.to(torch.float64) for t in s[:3]]).tolist()
    print(f"Mean reprojection error: {mean:g}")
    print(f"Inlier mean reprojection error: {inl:g}"
          f" ({int(n_inl)} / {s.n_observations} inliers)")
    return n_inl / s.n_observations


def show_objective(state, obs, avg_focal_length, inlier_threshold) -> float:
    """Print the reference's "True objective" line; returns the objective."""
    obj = true_objective(state, obs, avg_focal_length, inlier_threshold).item()
    print(f"True objective: {obj:g}")
    return obj

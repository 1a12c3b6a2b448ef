"""Rodrigues exponential map (reference MathUtils.h:66-82)."""

from __future__ import annotations

import torch

#: Small-angle cutoff of the reference exp map (MathUtils.h:74).
RODRIGUES_EPS = 1e-6


def cross_product_matrix(v: torch.Tensor) -> torch.Tensor:
    """[v]_x with [v]_x @ w == cross(v, w); (..., 3) -> (..., 3, 3)."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(vx)
    return torch.stack(
        [
            torch.stack([zero, -vz, vy], dim=-1),
            torch.stack([vz, zero, -vx], dim=-1),
            torch.stack([-vy, vx, zero], dim=-1),
        ],
        dim=-2,
    )


def exp_rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """R = I + c1 [w]_x + c2 [w]_x^2 with c1 = sin(t)/t, c2 = (1-cos t)/t^2.

    Below |t| <= 1e-6 the Taylor coefficients c1 = 1 - t^2/6 and
    c2 = 1/2 - t^2/24 replace the reference's hard switch to the identity
    (the same documented deviation as the JAX package). (..., 3) -> (..., 3, 3).
    """
    theta2 = (omega * omega).sum(-1)
    small = theta2 <= RODRIGUES_EPS * RODRIGUES_EPS
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    c1 = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    c2 = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe)
    )
    J = cross_product_matrix(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(J.shape)
    return eye + c1[..., None, None] * J + c2[..., None, None] * (J @ J)

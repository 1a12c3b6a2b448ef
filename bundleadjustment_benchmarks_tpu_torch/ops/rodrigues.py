"""Rotation maps: the Rodrigues exponential and logarithm and the quaternion
conversions (reference MathUtils.h:13-94)."""

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


def quaternion_from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) of a rotation matrix (reference
    MathUtils.h:23-40, with R(2,1) read where the reference reads R(1,2),
    as the JAX package does). (..., 3, 3) -> (..., 4)."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    zero = torch.zeros_like(m00)
    qw = torch.sqrt(torch.maximum(zero, 1.0 + m00 + m11 + m22)) / 2
    qx = torch.sqrt(torch.maximum(zero, 1.0 + m00 - m11 - m22)) / 2
    qy = torch.sqrt(torch.maximum(zero, 1.0 - m00 + m11 - m22)) / 2
    qz = torch.sqrt(torch.maximum(zero, 1.0 - m00 - m11 + m22)) / 2
    # The reference's copysign (MathUtils.h:9-11): negative iff y < 0.
    qx = torch.where(R[..., 2, 1] - R[..., 1, 2] < 0, -qx, qx)
    qy = torch.where(R[..., 0, 2] - R[..., 2, 0] < 0, -qy, qy)
    qz = torch.where(R[..., 1, 0] - R[..., 0, 1] < 0, -qz, qz)
    return torch.stack([qx, qy, qz, qw], dim=-1)


def rotation_matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a quaternion (x, y, z, w), normalized first; the
    zero quaternion gives the identity (reference MathUtils.h:42-64).
    (..., 4) -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    length = torch.sqrt(x * x + y * y + z * z + w * w)
    pos = length > 0
    s = torch.where(pos, 1.0 / torch.where(pos, length, torch.ones_like(length)),
                    torch.zeros_like(length))
    x, y, z, w = x * s, y * s, z * s, w * s
    wx, wy, wz = 2 * w * x, 2 * w * y, 2 * w * z
    xx, xy, xz = 2 * x * x, 2 * x * y, 2 * x * z
    yy, yz, zz = 2 * y * y, 2 * y * z, 2 * z * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([one - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, one - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, one - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def log_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector of a rotation matrix by the reference's recipe
    (MathUtils.h:84-94): normalize(q.xyz) * 2 acos(q.w). The identity gives
    zeros where the reference normalizes a zero vector (NaN).
    (..., 3, 3) -> (..., 3)."""
    q = quaternion_from_rotation_matrix(R)
    xyz = q[..., :3]
    norm = torch.sqrt((xyz * xyz).sum(-1, keepdim=True))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    angle = 2.0 * torch.arccos(torch.clamp(q[..., 3:4], -1.0, 1.0))
    return torch.where(norm > 0, xyz / safe * angle, torch.zeros_like(xyz))

"""The reference CameraMatrix surface as functions of (K, R, T) tensors.

Port of the JAX package's ``models/camera.py`` (reference
CameraMatrix.{h,cpp}); every function broadcasts over leading batch dims.

  setProjection / RQ decomposition :33-91   -> decompose_projection
  world<->camera transforms :259-273        -> transform_* functions
  projectPoint (linear) :218-223            -> project_point_linear
  projectPoint (distorted) :225-236         -> projection.project_affine
  unprojectPixel :238-250                   -> unproject_pixel
  intersectRayWithPlane :252-257            -> intersect_ray_with_plane
  getRay / getCameraCenter :151-163         -> get_ray / camera_center
  optical axis / up / right :165-179        -> optical_axis, up_vector, right_vector
  isOnGoodSide :181-183                     -> is_on_good_side
  normalized coordinates :275-287           -> to/from_normalized_coordinate
  getFocalLength/AspectRatio/PrincipalPoint :207-216 -> accessors
"""

from __future__ import annotations

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import projection as projection_ops


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _mtv(A, x):
    """A^T x."""
    return torch.einsum("...ji,...j->...i", A, x)


def camera_center(R, T):
    """c = -R^T T (CameraMatrix.cpp:296-297)."""
    return -_mtv(R, T)


def orientation(R, T):
    """[R | T] as (..., 3, 4)."""
    return torch.cat([R, T[..., :, None]], dim=-1)


def projection_matrix(K, R, T):
    """P = K [R | T] (CameraMatrix.cpp:200-204)."""
    return torch.einsum("...ij,...jk->...ik", K, orientation(R, T))


def decompose_projection(P):
    """P = K [R | T] -> (K, R, T) by an RQ decomposition, from the QR of the
    reversed transpose: with J the exchange matrix, M^T J = Q~ R~ gives
    M = (J R~^T J)(J Q~^T). K is scaled to K[2,2] = 1 with a positive
    diagonal (CameraMatrix.cpp:33-91)."""
    M = P[..., :3]
    Qt, Rt = torch.linalg.qr(torch.flip(M.transpose(-1, -2), dims=(-1,)))
    K = torch.flip(Rt.transpose(-1, -2), dims=(-1, -2))
    R = torch.flip(Qt.transpose(-1, -2), dims=(-2,))
    diag = torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 2, 2]], dim=-1)
    sign = torch.where(torch.sign(diag) == 0, torch.ones_like(diag),
                       torch.sign(diag))
    K = K * sign[..., None, :]
    R = R * sign[..., :, None]
    T = torch.linalg.solve(K, P[..., 3][..., None])[..., 0]
    return K / K[..., 2:3, 2:3], R, T


def focal_length(K):
    """K(0,0) (CameraMatrix.cpp:207-209)."""
    return K[..., 0, 0]


def aspect_ratio(K):
    """K(1,1)/K(0,0) (CameraMatrix.cpp:211-213)."""
    return K[..., 1, 1] / K[..., 0, 0]


def principal_point(K):
    """(K(0,2), K(1,2)) (CameraMatrix.cpp:215-217)."""
    return torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)


def transform_point_into_camera_space(R, T, p):
    """R p + T (CameraMatrix.cpp:259-261)."""
    return projection_ops.transform_into_camera_space(R, T, p)


def transform_point_from_camera_space(R, T, p):
    """R^T (p - T) (CameraMatrix.cpp:263-265)."""
    return _mtv(R, p - T)


def transform_direction_into_camera_space(R, d):
    """R d (CameraMatrix.cpp:271-273)."""
    return _mv(R, d)


def transform_direction_from_camera_space(R, d):
    """R^T d (CameraMatrix.cpp:267-269)."""
    return _mtv(R, d)


def to_normalized_coordinate(K, p):
    """(K00 p0 + K01 p1 + K02, K11 p1 + K12) (CameraMatrix.cpp:275-280)."""
    return projection_ops.apply_intrinsics(K, p)


def from_normalized_coordinate(K, p):
    """The inverse of to_normalized_coordinate by the rows of K^-1
    (CameraMatrix.cpp:282-287)."""
    Kinv = torch.linalg.inv(K)
    out0 = (Kinv[..., 0, 0] * p[..., 0] + Kinv[..., 0, 1] * p[..., 1]
            + Kinv[..., 0, 2])
    out1 = Kinv[..., 1, 1] * p[..., 1] + Kinv[..., 1, 2]
    return torch.stack([out0, out1], dim=-1)


def project_point_linear(K, R, T, X):
    """Distortion-free q = K (R X + T), returned as (q0/q2, q1/q2)
    (CameraMatrix.cpp:218-223)."""
    q = _mv(K, transform_point_into_camera_space(R, T, X))
    return q[..., :2] / q[..., 2:3]


def _pixel_ray(K, p):
    """K^-1 [p; 1]."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return _mv(torch.linalg.inv(K), ph)


def get_ray(K, R, T, p):
    """World-space ray R^T K^-1 [p; 1] through pixel p (CameraMatrix.cpp:151-157)."""
    return _mtv(R, _pixel_ray(K, p))


def unproject_pixel(K, R, T, p, depth):
    """Pixel and depth -> world point (CameraMatrix.cpp:238-250)."""
    ray = _pixel_ray(K, p)
    ray = ray * (depth / ray[..., 2])[..., None]
    return camera_center(R, T) + _mtv(R, ray)


def intersect_ray_with_plane(K, R, T, plane, x, y):
    """The ray through pixel (x, y) meets the plane (n, d)
    (CameraMatrix.cpp:252-257)."""
    p = torch.stack([torch.as_tensor(x, dtype=K.dtype, device=K.device),
                     torch.as_tensor(y, dtype=K.dtype, device=K.device)], dim=-1)
    ray = get_ray(K, R, T, p)
    c = camera_center(R, T)
    n = plane[..., :3]
    rho = (-(n * c).sum(-1) - plane[..., 3]) / (n * ray).sum(-1)
    return c + rho[..., None] * ray


def optical_axis(R):
    """Third row of R: the world-space viewing direction (CameraMatrix.cpp:165-167)."""
    return R[..., 2, :]


def up_vector(R):
    """R^T [0,1,0] (CameraMatrix.cpp:169-171)."""
    return R[..., 1, :]


def right_vector(R):
    """R^T [1,0,0] (CameraMatrix.cpp:173-175)."""
    return R[..., 0, :]


def is_on_good_side(R, T, p):
    """True where p lies in front of the camera, z > 0 in its frame
    (CameraMatrix.cpp:181-183)."""
    return transform_point_into_camera_space(R, T, p)[..., 2] > 0

"""Camera projection with radial distortion, residuals and energies.

f64 drive: ``residuals``/``energy`` on a ``BAState`` (reference
CameraMatrix.cpp:259-261, DistortionFunction.cpp:14-23, BAFunctor.h:151-178).

df32 drive: planar ("component, K") functions on float32 rows. Each
observation's camera parameters come from the (27, N) pack of
``planar_camera_pack``; points are a DF (hi, lo) pair of (3, M) rows. These
are the plain versions of the CUDA chain kernels: ``csrc/chain_math.cuh``
repeats them op for op.
"""

from __future__ import annotations

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import robust
from bundleadjustment_benchmarks_tpu_torch.ops import twofloat as tf


def distort(k1, k2, xu):
    """xd = (1 + k1 r^2 + k2 r^4) xu with r^2 = |xu|^2."""
    r2 = (xu * xu).sum(-1)
    kr = 1.0 + k1 * r2 + k2 * r2 * r2
    return kr[..., None] * xu


def transform_into_camera_space(R, T, X):
    """R X + T; (..., 3, 3), (..., 3), (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, X) + T


def project_affine(K, R, T, k1, k2, X):
    """Full-intrinsic projection of the statistics printouts (reference
    CameraMatrix::projectPoint, CameraMatrix.cpp:225-236): p =
    distort(perspective(R X + T)), out = (K00 p0 + K01 p1 + K02,
    K11 p1 + K12). For BAL data (K01 = K02 = K12 = 0) it is the residual's
    projection."""
    XX = transform_into_camera_space(R, T, X)
    return apply_intrinsics(K, distort(k1, k2, XX[..., :2] / XX[..., 2:3]))


def apply_intrinsics(K, p):
    """(K00 p0 + K01 p1 + K02, K11 p1 + K12) (CameraMatrix.cpp:275-280)."""
    out0 = K[..., 0, 0] * p[..., 0] + K[..., 0, 1] * p[..., 1] + K[..., 0, 2]
    out1 = K[..., 1, 1] * p[..., 1] + K[..., 1, 2]
    return torch.stack([out0, out1], dim=-1)


def residuals_raw(state, obs, compute_dtype=None) -> torch.Tensor:
    """Unrobustified residuals project - measurement, (K, 2).

    ``compute_dtype``: R X + T stays in the state dtype (far-field
    cancellation); the rest of the chain runs in compute_dtype."""
    ci = obs.cam_idx
    R, T = state.R[ci], state.T[ci]
    focal, k1, k2 = state.K[ci, 0, 0], state.k1[ci], state.k2[ci]
    X = state.points[obs.pt_idx]
    XX = torch.einsum("kij,kj->ki", R, X) + T
    meas = obs.measurements
    if compute_dtype is not None and XX.dtype != compute_dtype:
        XX, focal, k1, k2, meas = (
            t.to(compute_dtype) for t in (XX, focal, k1, k2, meas)
        )
    xu = XX[:, :2] / XX[:, 2:3]
    return focal[:, None] * distort(k1, k2, xu) - meas


def residuals(state, obs, tau2, compute_dtype=None) -> torch.Tensor:
    """Robustified residuals r * sqrt(psi(|r|^2)) / max(eps, |r|), (K, 2)."""
    r = residuals_raw(state, obs, compute_dtype)
    return r * robust.robust_scale(tau2, r)[:, None]


def energy(state, obs, tau2, compute_dtype=None) -> torch.Tensor:
    """LM objective sum(f^2) as a float64 0-dim tensor."""
    f = residuals(state, obs, tau2, compute_dtype)
    return (f.to(torch.float64) ** 2).sum()


#: Planar camera pack rows: 9 R.hi, 9 R.lo, 3 T.hi, 3 T.lo, focal, k1, k2.
CAM_PACK_ROWS = 27


def planar_camera_pack(fast) -> torch.Tensor:
    """(27, N) float32 pack of the per-camera parameters (N-sized split of
    the float64 R and T into DF halves)."""
    R_df = tf.from_array(fast.R)
    T_df = tf.from_array(fast.T)
    return torch.cat(
        [
            R_df.hi.reshape(-1, 9).T,
            R_df.lo.reshape(-1, 9).T,
            T_df.hi.T,
            T_df.lo.T,
            fast.K[:, 0, 0].to(torch.float32)[None],
            fast.k1.to(torch.float32)[None],
            fast.k2.to(torch.float32)[None],
        ],
        dim=0,
    )


def planar_gather(fast, obs):
    """Per-observation planar operands: camg (27, K), ptsg (6, K) float32."""
    cam = planar_camera_pack(fast)
    pts = torch.cat([fast.points.hi, fast.points.lo], dim=0)  # (6, M)
    return cam[:, obs.cam_idx], pts[:, obs.pt_idx]


def planar_transform_df(camg, ptsg):
    """World->camera transform in DF arithmetic on planar components.

    Returns (RX: 3 DF == R X, XX: 3 DF == R X + T)."""
    X = [tf.DF(ptsg[i], ptsg[3 + i]) for i in range(3)]

    def R_df(i, j):
        return tf.DF(camg[3 * i + j], camg[9 + 3 * i + j])

    RX = []
    for i in range(3):
        acc = tf.mul(R_df(i, 0), X[0])
        acc = tf.add(acc, tf.mul(R_df(i, 1), X[1]))
        acc = tf.add(acc, tf.mul(R_df(i, 2), X[2]))
        RX.append(acc)
    XX = [tf.add(RX[i], tf.DF(camg[18 + i], camg[21 + i])) for i in range(3)]
    return RX, XX


def planar_residual_comps(camg, XX, m0, m1):
    """(r0, r1, kr, xu0, xu1, r2, invz) float32 rows of the raw residual."""
    invz = torch.reciprocal(XX[2].hi)
    xu0 = XX[0].hi * invz
    xu1 = XX[1].hi * invz
    r2 = xu0 * xu0 + xu1 * xu1
    k1, k2, focal = camg[25], camg[26], camg[24]
    kr = 1.0 + k1 * r2 + k2 * r2 * r2
    r0 = focal * kr * xu0 - m0
    r1 = focal * kr * xu1 - m1
    return r0, r1, kr, xu0, xu1, r2, invz


def planar_energy_df(camg, XX, m0, m1, tau2) -> tf.DF:
    """Per-observation robustified squared residual as a DF.

    ``tau2`` is a float32 0-dim tensor on the rows' device. The scale is the
    stable ``cd`` of robust.outer_coeffs, so the energy is exactly the
    objective whose derivative the planar Jacobian computes."""
    r0, r1, *_ = planar_residual_comps(camg, XX, m0, m1)
    rn2 = r0 * r0 + r1 * r1
    _, s = robust.outer_coeffs(rn2, tau2)
    return tf.add(tf.prod_ff(r0 * s, r0 * s), tf.prod_ff(r1 * s, r1 * s))


def tau2_f32(tau2: float, device) -> torch.Tensor:
    """The robust threshold as the float32 0-dim tensor the df32 rows use
    (a fill on the device: no host copy, so it can be captured)."""
    return torch.full((), tau2, dtype=torch.float32, device=device)


def energy_fast(fast, obs, tau2) -> torch.Tensor:
    """df32 objective: DF tree sum of the per-observation energies (float64)."""
    camg, ptsg = planar_gather(fast, obs)
    _, XX = planar_transform_df(camg, ptsg)
    m = obs.measurements_pl
    e = tf.sum_df(
        planar_energy_df(camg, XX, m[0], m[1], tau2_f32(tau2, m.device))
    )
    return tf.to_f64(e)


def compensated_square_sum(f: torch.Tensor) -> torch.Tensor:
    """sum(f*f) with DF accumulation for float32; float64 result."""
    if f.dtype == torch.float64:
        return (f * f).sum()
    return tf.to_f64(tf.sum_df(tf.prod_ff(f, f)))

"""Generator of BAL-format stand-ins, frozen for the benchmark.

Copied from ``bundleadjustment_benchmarks_tpu_torch/utils/balgen.py`` at
commit 306ffbcb20dbd48e32330260e2650eb0bfef3067 (``generate_bal_like`` and
its helpers, numpy only), returning the raw arrays as a dict keyed like
``baltext.FIELDS``. A seed gives the same arrays as the port's copy did at
that commit. The model, fitted to the measured statistics of BAL's
problem-21 and problem-39:

* point degrees from problem-39's empirical histogram (min 2, tail to ~20),
  tilted to a requested mean degree (``mean_degree`` = K / M);
* camera loads spread ~4.7x (lognormal camera weights);
* co-visibility in a contiguous window of at most 24 cameras along a
  trajectory (an arc around a plaza);
* focal lengths log-uniform over 1.35e3..1.2e4, raw k1/k2 at 1e-8/1e-14;
* measurements: exact projections of the true geometry plus 0.08 px noise;
  the geometry written out is perturbed (an outlier tail on the points,
  small camera errors).
"""

from __future__ import annotations

import numpy as np

#: Empirical point-degree histogram of problem-39-18060-pre (degree: count).
#: problem-21's is the same shape with a shorter tail.
_DEGREE_HIST = {
    2: 9366, 3: 3104, 4: 1812, 5: 1027, 6: 733, 7: 549, 8: 417, 9: 326,
    10: 219, 11: 173, 12: 116, 13: 64, 14: 76, 15: 39, 16: 24, 17: 11,
    18: 1, 19: 2, 20: 1,
}


def _rodrigues(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    safe = np.where(theta > 0, theta, 1.0)
    k = w / safe
    Kx = np.zeros(w.shape[:-1] + (3, 3))
    Kx[..., 0, 1], Kx[..., 0, 2] = -k[..., 2], k[..., 1]
    Kx[..., 1, 0], Kx[..., 1, 2] = k[..., 2], -k[..., 0]
    Kx[..., 2, 0], Kx[..., 2, 1] = -k[..., 1], k[..., 0]
    st, ct = np.sin(theta)[..., None], np.cos(theta)[..., None]
    return np.eye(3) + st * Kx + (1 - ct) * (Kx @ Kx)


def _log_rodrigues(R: np.ndarray) -> np.ndarray:
    """Inverse of _rodrigues for the generated look-at rotations."""
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(tr)
    ax = np.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], axis=-1,
    )
    s = np.linalg.norm(ax, axis=-1, keepdims=True)
    s = np.where(s > 1e-12, s, 1.0)
    return ax / s * theta[..., None]


def generate_bal_like(
    n_cameras: int,
    n_points: int,
    seed: int = 0,
    mean_degree: float | None = None,
    point_sigma: float = 3.5e-4,
    outlier_frac: float = 0.25,
    outlier_scale: float = 10.0,
) -> dict:
    """Generate a BAL-structure problem; see module docstring for the model."""
    rng = np.random.default_rng(seed)
    n, m = n_cameras, n_points

    # --- camera trajectory (Trafalgar-like arc around a plaza) ---
    scene_center = np.array([0.5, 0.27, -2.5])

    t = np.linspace(0, 1.5 * np.pi, n) + rng.normal(scale=0.05, size=n)
    radius = 3.0 + rng.normal(scale=0.3, size=n)
    centers = np.stack(
        [
            scene_center[0] + radius * np.cos(t),
            scene_center[1] + 0.3 * rng.normal(size=n),
            scene_center[2] + radius * np.sin(t),
        ],
        axis=1,
    )
    # Look-at rotations: camera z axis toward the scene center (+ jitter);
    # BAL's convention puts visible points at positive camera-frame depth
    # (the negative focal in K flips the image axes, not the depth sign).
    fwd = scene_center - centers + rng.normal(scale=0.15, size=(n, 3))
    fwd /= np.linalg.norm(fwd, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 1.0, 0.0]), (n, 1))
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)  # rows = camera axes
    T = -np.einsum("nij,nj->ni", R, centers)

    focal = np.exp(rng.uniform(np.log(1.35e3), np.log(1.2e4), size=n))
    k1 = rng.normal(scale=3e-8, size=n)
    k2 = rng.normal(scale=1e-14, size=n)

    # --- observation structure ---
    degrees = np.array(sorted(_DEGREE_HIST), dtype=np.int64)
    weights = np.array([_DEGREE_HIST[d] for d in degrees], dtype=np.float64)
    weights /= weights.sum()
    if mean_degree is not None:
        # Tilt the empirical histogram to hit a requested mean (K/M ratio).
        for _ in range(60):
            cur = float(degrees @ weights)
            weights = weights * np.exp((mean_degree - cur) * 0.02 * degrees)
            weights /= weights.sum()
    deg = rng.choice(degrees, size=m, p=weights)
    deg = np.minimum(deg, n)

    # Camera-load weights (lognormal ~4.7x spread) bias the center-camera
    # choice; each point then sees a contiguous-window sample around it.
    cam_w = np.exp(rng.normal(scale=0.45, size=n))
    cam_w /= cam_w.sum()
    center_cam = rng.choice(n, size=m, p=cam_w)
    window = max(2, min(int(round(n / 2.2)), 24))

    # --- points: sampled INSIDE the center camera's viewing frustum ---
    # (real points exist because a feature was detected in frame: |meas| is
    # bounded by the sensor, ~1700 px in the bundled files). Unproject a
    # uniform in-frame pixel at lognormal depth through the center camera.
    max_px = 1650.0
    xu_lim = max_px / focal[center_cam]
    xu_c = rng.uniform(-1, 1, size=(m, 2)) * (0.94 * xu_lim[:, None]) * np.array([1.0, 0.62])
    depth = np.clip(np.exp(rng.normal(np.log(3.0), 0.4, size=m)), 1.2, 9.0)
    cam_pt = np.concatenate([xu_c * depth[:, None], depth[:, None]], axis=1)
    points = np.einsum(
        "mji,mj->mi", R[center_cam], cam_pt - T[center_cam]
    )  # R^T (X_cam - T)

    dmax = int(deg.max())
    # Candidate partner cameras: contiguous window around the center.
    offs = rng.integers(-window, window + 1, size=(m, dmax + 12))
    cand = np.clip(center_cam[:, None] + offs, 0, n - 1)
    cand[:, 0] = center_cam

    # Validity of each candidate: in front (z) and in frame (|meas|).
    def _project(ci_flat, pi_flat):
        XX = (
            np.einsum("kij,kj->ki", R[ci_flat], points[pi_flat])
            + T[ci_flat]
        )
        xu = XX[:, :2] / XX[:, 2:3]
        r2 = np.sum(xu * xu, axis=1)
        kr = 1 + (k1 * focal**2)[ci_flat] * r2 + (k2 * focal**4)[ci_flat] * r2**2
        return (-focal[ci_flat] * kr)[:, None] * xu, XX[:, 2]

    pi_rep = np.repeat(np.arange(m, dtype=np.int64)[:, None], cand.shape[1], 1)
    meas_c, z_c = _project(cand.reshape(-1), pi_rep.reshape(-1))
    ok = (z_c > 0.8) & (np.abs(meas_c) < 1.1 * max_px).all(axis=1)
    ok = ok.reshape(m, -1)

    # First-`deg` valid distinct cameras per point (vectorized over chunks).
    obs_cam = np.full((m, dmax), -1, dtype=np.int64)
    for row in range(0, m, 65536):
        sl = slice(row, min(row + 65536, m))
        c = cand[sl]
        okc = ok[sl]
        seen = np.zeros((c.shape[0], n), dtype=bool)
        out = obs_cam[sl]
        col = np.zeros(c.shape[0], dtype=np.int64)
        rows_ = np.arange(c.shape[0])
        for j in range(c.shape[1]):
            cj = c[:, j]
            fresh = okc[:, j] & ~seen[rows_, cj] & (col < deg[sl])
            out[fresh, col[fresh]] = cj[fresh]
            seen[rows_, cj] |= fresh
            col += fresh
        obs_cam[sl] = out
    # Rare tail-of-the-distortion-distribution points can fail even their
    # center camera's frame bound; force the center observation so no point
    # is unobserved (a slightly out-of-frame measurement is harmless).
    none_row = obs_cam[:, 0] < 0
    obs_cam[none_row, 0] = center_cam[none_row]
    valid = obs_cam >= 0
    # Points whose window can't fill the degree keep what they found (the
    # center camera now always participates, so every point has >= 1
    # observation; real BAL min degree is 2 and >99% reach it here).
    pt_idx = np.repeat(np.arange(m, dtype=np.int64), valid.sum(axis=1))
    cam_idx = obs_cam[valid]

    # --- exact measurements from TRUE geometry (BAL conventions) ---
    meas, _ = _project(cam_idx, pt_idx)
    meas += rng.normal(scale=0.08, size=meas.shape)  # tracker noise floor

    # --- perturb the geometry written to file (the "-pre" state) ---
    scale = np.where(
        rng.random(m) < outlier_frac,
        outlier_scale * point_sigma,
        point_sigma,
    )
    pts_pre = points + rng.normal(size=(m, 3)) * scale[:, None]
    omega = _log_rodrigues(R)
    # Re-derive R from omega so the written file round-trips exactly, then
    # add small camera error.
    omega += rng.normal(scale=8e-5, size=omega.shape)
    T_pre = T + rng.normal(scale=1.2e-4, size=T.shape)

    return {
        "cam_idx": cam_idx.astype(np.int32),
        "pt_idx": pt_idx.astype(np.int32),
        "measurements": meas,
        "omega": omega,
        "translation": T_pre,
        "focal": focal,
        "k1": k1,
        "k2": k2,
        "points": pts_pre,
    }

"""Robust bundle adjustment in plain float64 PyTorch: the BAL camera model,
the robust energy, the Jacobian blocks, the Schur-reduced damped step and
one Levenberg-Marquardt iteration with its damping rules.

The conventions are the reference binaries' (bundle_adjustment_large.cpp:
57-108, BAFunctor.h, BacktrackLevMarqCholesky.h), as the BAL format and
the benchmark's configurations state them:

* a camera is (R, T, f, k1, k2) with R = exp([omega]_x), f the negated
  focal length (K = diag(-f, -f, 1)), k1 and k2 pre-scaled to k1 f^2 and
  k2 f^4; a point X is seen at f (1 + k1 r^2 + k2 r^4) (x / z, y / z) with
  (x, y, z) = R X + T and r^2 = (x^2 + y^2) / z^2;
* the residual r = projection - measurement is robustified by the smooth
  truncated quadratic psi(s) = s (2 - s / tau^2) / 4 below tau^2 and
  tau^2 / 4 above it; the energy is the sum of psi(|r|^2), and the
  robustified residual is r sqrt(psi) / |r|;
* a step is [dT, domega, df, dk1, dk2] per camera and dX per point, applied
  as T += dT, R <- exp([domega]_x) R, f += df, k1 += dk1, k2 += dk2,
  X += dX;
* the damped normal equations (J^T J + lam I) dx = -J^T f are solved by
  eliminating the 3x3 point blocks and solving the dense reduced camera
  system by Cholesky (LU where Cholesky breaks down);
* LM: lam starts at 1e-12 max diag(J^T J) (cholesky, qrchol) or 1e-6
  sqrt(max diag(J^T J)) (the other modes); an accepted trial scales lam by
  max(1/3, 1 - (2 rho - 1)^3) with rho = (E - E_trial) / (dx^T (lam dx -
  J^T f)), clamped below at lambda_min; a rejected one stops the run where
  lam > lambda_max and otherwise grows lam by 2, then by the previous
  factor to the power 1.5.

Everything is float64 on the tensors' device. Large sums run in blocks of
observations or camera pairs, so that the Ladybug stand-in fits beside a
freed program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

F64 = torch.float64
#: Below this rotation angle exp uses its Taylor coefficients.
SMALL_ANGLE = 1e-6
#: Camera-pair blocks summed into the reduced system per call.
PAIR_CHUNK = 1 << 19


@dataclasses.dataclass
class State:
    """R (N,3,3), T (N,3), f (N,) negated focal, k1 (N,), k2 (N,) pre-scaled,
    X (M,3); all float64."""

    R: torch.Tensor
    T: torch.Tensor
    f: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    X: torch.Tensor


@dataclasses.dataclass
class Problem:
    """Observations: camera and point index (K,) int64, measurement (K,2);
    tau2, the squared inlier threshold; and the camera-pair tables of the
    reduced system, built on first use."""

    cam: torch.Tensor
    pt: torch.Tensor
    meas: torch.Tensor
    tau2: float
    n_cameras: int
    n_points: int
    _pairs: tuple | None = None

    @property
    def n_observations(self) -> int:
        return self.cam.shape[0]


def cross(v: torch.Tensor) -> torch.Tensor:
    """[v]_x of (..., 3) as (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """exp([w]_x) = I + sin(t)/t [w]_x + (1 - cos t)/t^2 [w]_x^2."""
    t2 = (w * w).sum(-1)
    small = t2 <= SMALL_ANGLE ** 2
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    c1 = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    c2 = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    K = cross(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + c1[..., None, None] * K + c2[..., None, None] * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """w with exp([w]_x) = R, for rotations by less than pi: the angle from
    atan2(|vee|, (tr - 1) / 2), accurate near the identity."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2.0
    s = torch.linalg.vector_norm(v, dim=-1)
    c = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0
    t = torch.atan2(s, c)
    scale = torch.where(s > 1e-300, t / torch.where(s > 1e-300, s, 1.0),
                        torch.ones_like(s))
    return v * scale[..., None]


def from_raw(raw: dict, inlier_threshold: float, device) -> tuple:
    """(Problem, State) of raw BAL arrays (``core.baltext.FIELDS``)."""
    def t(x):
        return torch.as_tensor(x, dtype=F64, device=device)

    focal = t(raw["focal"])
    state = State(R=exp_so3(t(raw["omega"])), T=t(raw["translation"]),
                  f=-focal, k1=t(raw["k1"]) * focal ** 2,
                  k2=t(raw["k2"]) * focal ** 4, X=t(raw["points"]))
    prob = Problem(
        cam=torch.as_tensor(raw["cam_idx"], dtype=torch.int64, device=device),
        pt=torch.as_tensor(raw["pt_idx"], dtype=torch.int64, device=device),
        meas=t(raw["measurements"]), tau2=float(inlier_threshold) ** 2,
        n_cameras=int(focal.shape[0]), n_points=int(state.X.shape[0]))
    return prob, state


def _camera_frame(s: State, prob: Problem):
    R = s.R[prob.cam]
    XX = torch.einsum("kij,kj->ki", R, s.X[prob.pt]) + s.T[prob.cam]
    return R, XX


def residuals(s: State, prob: Problem) -> torch.Tensor:
    """Raw residuals projection - measurement, (K, 2)."""
    _, XX = _camera_frame(s, prob)
    xu = XX[:, :2] / XX[:, 2:3]
    r2 = (xu * xu).sum(-1)
    kr = 1.0 + s.k1[prob.cam] * r2 + s.k2[prob.cam] * r2 * r2
    return (s.f[prob.cam] * kr)[:, None] * xu - prob.meas


def psi(s2: torch.Tensor, tau2: float) -> torch.Tensor:
    return torch.where(s2 < tau2, s2 * (2.0 - s2 / tau2) / 4.0,
                       torch.full_like(s2, tau2 / 4.0))


def energy(s: State, prob: Problem) -> float:
    """Sum of psi(|r|^2) over the observations."""
    r = residuals(s, prob)
    return float(psi((r * r).sum(-1), prob.tau2).sum())


def blocks(s: State, prob: Problem) -> tuple:
    """(f (K,2), Jc (K,2,9), Jp (K,2,3)): the robustified residuals and
    their Jacobian with respect to [dT, domega, df, dk1, dk2] and dX."""
    R, XX = _camera_frame(s, prob)
    cam = prob.cam
    z = XX[:, 2]
    xu = XX[:, :2] / z[:, None]
    x, y = xu[:, 0], xu[:, 1]
    r2 = x * x + y * y
    k1, k2, f = s.k1[cam], s.k2[cam], s.f[cam]
    kr = 1.0 + k1 * r2 + k2 * r2 * r2
    r = (f * kr)[:, None] * xu - prob.meas
    zero = torch.zeros_like(z)
    dxu = torch.stack([torch.stack([1 / z, zero, -x / z], -1),
                       torch.stack([zero, 1 / z, -y / z], -1)], -2)
    dkr = 2.0 * k1 + 4.0 * k2 * r2
    dxd = torch.stack([torch.stack([kr + x * x * dkr, x * y * dkr], -1),
                       torch.stack([x * y * dkr, kr + y * y * dkr], -1)], -2)
    dr_dXX = f[:, None, None] * (dxd @ dxu)
    RX = XX - s.T[cam]
    Jc = torch.cat([dr_dXX, dr_dXX @ (-cross(RX)), (kr[:, None] * xu)[..., None],
                    (f[:, None] * xu * r2[:, None])[..., None],
                    (f[:, None] * xu * (r2 * r2)[:, None])[..., None]], -1)
    Jp = dr_dXX @ R
    # d(r sqrt(psi)/|r|)/dr = cd I + cr r r^T, exactly, on either branch.
    s2 = (r * r).sum(-1)
    inlier = s2 < prob.tau2
    som = torch.sqrt(torch.clamp(2.0 - s2 / prob.tau2, min=1.0))
    tau = math.sqrt(prob.tau2)
    rn = torch.sqrt(torch.maximum(s2, torch.full_like(s2, prob.tau2)))
    cd = torch.where(inlier, som / 2.0, tau / (2.0 * rn))
    cr = torch.where(inlier, -1.0 / (2.0 * prob.tau2 * som), -tau / (2.0 * rn ** 3))
    O = cd[:, None, None] * torch.eye(2, dtype=F64, device=r.device) \
        + cr[:, None, None] * r[:, :, None] * r[:, None, :]
    return cd[:, None] * r, O @ Jc, O @ Jp


@dataclasses.dataclass
class Normal:
    """The normal equations' blocks at one state: U (N,9,9), V (M,3,3),
    W (K,9,3), g_c (N,9), g_p (M,3) = -J^T f, and max diag(J^T J)."""

    U: torch.Tensor
    V: torch.Tensor
    W: torch.Tensor
    g_c: torch.Tensor
    g_p: torch.Tensor
    max_diag: float


def normal(s: State, prob: Problem) -> Normal:
    f, Jc, Jp = blocks(s, prob)
    n, m = prob.n_cameras, prob.n_points
    U = torch.zeros((n, 9, 9), dtype=F64, device=f.device).index_add_(
        0, prob.cam, Jc.transpose(1, 2) @ Jc)
    V = torch.zeros((m, 3, 3), dtype=F64, device=f.device).index_add_(
        0, prob.pt, Jp.transpose(1, 2) @ Jp)
    g_c = torch.zeros((n, 9), dtype=F64, device=f.device).index_add_(
        0, prob.cam, -torch.einsum("kri,kr->ki", Jc, f))
    g_p = torch.zeros((m, 3), dtype=F64, device=f.device).index_add_(
        0, prob.pt, -torch.einsum("kri,kr->ki", Jp, f))
    max_diag = max(float(torch.diagonal(U, dim1=1, dim2=2).max()),
                   float(torch.diagonal(V, dim1=1, dim2=2).max()))
    return Normal(U=U, V=V, W=Jc.transpose(1, 2) @ Jp, g_c=g_c, g_p=g_p,
                  max_diag=max_diag)


def _pairs(prob: Problem) -> tuple:
    """Every ordered pair (a, b) of observations of one point, and its
    camera-pair key cam[a] N + cam[b]: the blocks of the reduced system."""
    if prob._pairs is None:
        order = torch.argsort(prob.pt, stable=True)
        counts = torch.bincount(prob.pt, minlength=prob.n_points)
        starts = torch.cumsum(counts, 0) - counts
        a_parts, b_parts = [], []
        for d in torch.unique(counts).tolist():
            if d == 0:
                continue
            base = starts[counts == d]
            i = torch.arange(d, device=base.device)
            a_parts.append((base[:, None, None] + i[None, :, None]).expand(-1, d, d).reshape(-1))
            b_parts.append((base[:, None, None] + i[None, None, :]).expand(-1, d, d).reshape(-1))
        a = order[torch.cat(a_parts)]
        b = order[torch.cat(b_parts)]
        prob._pairs = (a, b, prob.cam[a] * prob.n_cameras + prob.cam[b])
    return prob._pairs


def damped_step(ne: Normal, lam: float, prob: Problem) -> tuple:
    """(dX (M,3), dc (N,9)) solving (J^T J + lam I) dx = -J^T f."""
    n, dev = prob.n_cameras, ne.U.device
    eye3 = torch.eye(3, dtype=F64, device=dev)
    Vinv = torch.linalg.inv(ne.V + lam * eye3)
    Y = ne.W @ Vinv[prob.pt]  # (K, 9, 3)
    b = ne.g_c - torch.zeros_like(ne.g_c).index_add_(
        0, prob.cam, torch.einsum("kij,kj->ki", Y, ne.g_p[prob.pt]))
    a, bb, key = _pairs(prob)
    Sblk = torch.zeros((n * n, 81), dtype=F64, device=dev)
    for lo in range(0, a.shape[0], PAIR_CHUNK):
        sl = slice(lo, lo + PAIR_CHUNK)
        Sblk.index_add_(0, key[sl],
                        (Y[a[sl]] @ ne.W[bb[sl]].transpose(1, 2)).reshape(-1, 81))
    S = -Sblk.view(n, n, 9, 9).permute(0, 2, 1, 3).reshape(9 * n, 9 * n)
    del Sblk
    diag = (ne.U + lam * torch.eye(9, dtype=F64, device=dev))
    for c in range(0, n, 4096):
        idx = torch.arange(c, min(c + 4096, n), device=dev)
        rows = (9 * idx[:, None] + torch.arange(9, device=dev)[None, :])
        S[rows[:, :, None], rows[:, None, :]] += diag[idx]
    d = torch.rsqrt(torch.diagonal(S))
    S.mul_(d[:, None]).mul_(d[None, :])
    rhs = b.reshape(-1) * d
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) == 0:
        x = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    else:
        x = torch.linalg.solve(S, rhs)
    del S, L
    dc = (x * d).reshape(n, 9)
    rhs_p = ne.g_p - torch.zeros_like(ne.g_p).index_add_(
        0, prob.pt, torch.einsum("kij,ki->kj", ne.W, dc[prob.cam]))
    dX = torch.einsum("mij,mj->mi", Vinv, rhs_p)
    return dX, dc


def apply_step(s: State, dX: torch.Tensor, dc: torch.Tensor) -> State:
    return State(R=exp_so3(dc[:, 3:6]) @ s.R, T=s.T + dc[:, 0:3],
                 f=s.f + dc[:, 6], k1=s.k1 + dc[:, 7], k2=s.k2 + dc[:, 8],
                 X=s.X + dX)


def camera_change(a: State, b: State) -> torch.Tensor:
    """The camera step (N, 9) that takes ``a``'s cameras to ``b``'s."""
    return torch.cat([b.T - a.T, log_so3(b.R @ a.R.transpose(1, 2)),
                      (b.f - a.f)[:, None], (b.k1 - a.k1)[:, None],
                      (b.k2 - a.k2)[:, None]], 1)


@dataclasses.dataclass
class LMRules:
    """The LM's constants (the reference binaries' defaults)."""

    lambda_min: float = 1e-10
    lambda_max: float = 1e10
    lambda_increase_base: float = 2.0
    max_trials: int = 129


def initial_lambda(ne: Normal, mode: str) -> float:
    if mode in ("cholesky", "qrchol"):
        return 1e-12 * ne.max_diag
    return 1e-6 * math.sqrt(ne.max_diag)


def growth(base: float, n: int) -> float:
    """lam's factor after the n-th reject in a row (n from 0)."""
    g = float(base)
    for _ in range(n):
        try:
            g = g ** 1.5
        except OverflowError:
            return math.inf
    return g


@dataclasses.dataclass
class Iteration:
    """One LM iteration's outcome."""

    state: State
    lam0: float
    lam: float
    trials: int
    accepted: bool
    energy: float
    dX: torch.Tensor | None
    dc: torch.Tensor | None


def lm_iteration(s: State, prob: Problem, lam: float | None, mode: str,
                 rules: LMRules = LMRules()) -> Iteration:
    """One iteration from ``s`` at ``lam`` (None: the mode's first-iteration
    rule): trials until one lowers the energy, or until a rejected trial at
    lam > lambda_max stops the run."""
    ne = normal(s, prob)
    e0 = energy(s, prob)
    if lam is None:
        lam = initial_lambda(ne, mode)
    lam0 = lam
    for n in range(rules.max_trials):
        dX, dc = damped_step(ne, lam, prob)
        trial = apply_step(s, dX, dc)
        e_t = energy(trial, prob)
        if e_t < e0:
            dx2 = float((dX * dX).sum() + (dc * dc).sum())
            gdot = float((dX * ne.g_p).sum() + (dc * ne.g_c).sum())
            rho = (e0 - e_t) / (lam * dx2 + gdot)
            t = 2.0 * rho - 1.0
            lam_new = max(lam * max(1.0 / 3.0, 1.0 - t * t * t), rules.lambda_min)
            return Iteration(trial, lam0, lam_new, n + 1, True, e_t, dX, dc)
        if lam > rules.lambda_max or not math.isfinite(lam):
            return Iteration(s, lam0, lam, n + 1, False, e0, None, None)
        lam = lam * growth(rules.lambda_increase_base, n)
    return Iteration(s, lam0, lam, rules.max_trials, False, e0, None, None)


def step_energy(s: State, prob: Problem, lam: float) -> float:
    """The energy after the damped step at ``lam`` from ``s``, accepted or
    not."""
    dX, dc = damped_step(normal(s, prob), lam, prob)
    return energy(apply_step(s, dX, dc), prob)


def backward_error(s: State, prob: Problem, lam: float, dX: torch.Tensor,
                   dc: torch.Tensor) -> float:
    """The Jacobi-scaled normwise backward error of a step in the damped
    normal equations at ``s``: with A = J^T J + lam I, b = -J^T f and
    D = diag(A)^-1/2, ||D (A dx - b)|| / (||D A D||_F ||dx / D|| + ||D b||).
    Directions that J does not see (the gauge) enter A dx only through
    lam, so the error reads the step where the data decide it."""
    f, Jc, Jp = blocks(s, prob)
    n, m = prob.n_cameras, prob.n_points
    dev = f.device
    Jdx = torch.einsum("kri,ki->kr", Jc, dc[prob.cam]) \
        + torch.einsum("kri,ki->kr", Jp, dX[prob.pt])
    r = Jdx + f  # A dx - b = J^T (J dx + f) + lam dx
    r_c = torch.zeros((n, 9), dtype=F64, device=dev).index_add_(
        0, prob.cam, torch.einsum("kri,kr->ki", Jc, r)) + lam * dc
    r_p = torch.zeros((m, 3), dtype=F64, device=dev).index_add_(
        0, prob.pt, torch.einsum("kri,kr->ki", Jp, r)) + lam * dX
    b_c = -torch.zeros((n, 9), dtype=F64, device=dev).index_add_(
        0, prob.cam, torch.einsum("kri,kr->ki", Jc, f))
    b_p = -torch.zeros((m, 3), dtype=F64, device=dev).index_add_(
        0, prob.pt, torch.einsum("kri,kr->ki", Jp, f))
    U = torch.zeros((n, 9, 9), dtype=F64, device=dev).index_add_(
        0, prob.cam, Jc.transpose(1, 2) @ Jc) + lam * torch.eye(9, dtype=F64, device=dev)
    V = torch.zeros((m, 3, 3), dtype=F64, device=dev).index_add_(
        0, prob.pt, Jp.transpose(1, 2) @ Jp) + lam * torch.eye(3, dtype=F64, device=dev)
    d_c = torch.rsqrt(torch.diagonal(U, dim1=1, dim2=2))
    d_p = torch.rsqrt(torch.diagonal(V, dim1=1, dim2=2))
    W = (Jc.transpose(1, 2) @ Jp) * d_c[prob.cam][:, :, None] * d_p[prob.pt][:, None, :]
    a_norm2 = float(((U * d_c[:, :, None] * d_c[:, None, :]) ** 2).sum()
                    + ((V * d_p[:, :, None] * d_p[:, None, :]) ** 2).sum()
                    + 2.0 * (W ** 2).sum())
    num = float(torch.sqrt(((d_c * r_c) ** 2).sum() + ((d_p * r_p) ** 2).sum()))
    x_norm = float(torch.sqrt(((dc / d_c) ** 2).sum() + ((dX / d_p) ** 2).sum()))
    b_norm = float(torch.sqrt(((d_c * b_c) ** 2).sum() + ((d_p * b_p) ** 2).sum()))
    return num / (math.sqrt(a_norm2) * x_norm + b_norm)

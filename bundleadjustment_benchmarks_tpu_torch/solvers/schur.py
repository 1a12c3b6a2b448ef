"""Schur-complement solve of the damped system, ``mode="cholesky"``.

The damped normal equations (J^T J + lam I) dx = -J^T f of bundle adjustment
are solved by eliminating the 3x3 point blocks (reference
BacktrackLevMarqCholesky.h:272-282, the SimplicialLDLT of the whole normal
matrix, realised here as a batched Schur elimination):

  * ``build_context`` (once per outer LM iteration): per-camera and
    per-point grams U, V and gradients from degree-banded segment sums, the
    per-observation coupling W = Jc^T Jp, a closed-form eigendecomposition
    V = Q diag(e) Q^T, and the lambda-independent gathers of the whitened
    coupling W Q into the observation-pair tables;
  * ``solve_damped`` (once per damping trial): the reduced camera system
    S = blkdiag(U + lam I) - sum W (V + lam I)^-1 W^T from the cached pair
    stacks weighted by 1/(e + lam), its Jacobi-scaled solve, and the point
    back-substitution through a clamped closed-form 3x3 Cholesky.

Only the cholesky mode on problems that carry pair and banded tables is in
this module; the other modes raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bundleadjustment_benchmarks_tpu_torch.ops import linalg
from bundleadjustment_benchmarks_tpu_torch.ops.jacobian import JacobianBlocks

MODES = ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")

#: (point_factor, camera_solver) per mode.
MODE_STRATEGY = {
    "cholesky": ("chol", "chol"),
    "qrchol": ("qr", "chol"),
    "qrkit": ("qr", "qr_cached"),
    "spqr": ("qr", "qr_full"),
    "moreqr": ("eig", "chol"),
}


def check_mode(mode: str) -> None:
    """Raise unless ``mode`` is one this package solves."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if mode != "cholesky":
        point_factor, camera_solver = MODE_STRATEGY[mode]
        raise NotImplementedError(
            f"mode {mode!r} (point factor {point_factor!r}, camera solver "
            f"{camera_solver!r}) is not ported yet: qrchol, moreqr, qrkit and "
            "spqr come with the solver-modes slice; use mode='cholesky'"
        )


@dataclasses.dataclass
class SchurContext:
    """Lambda-independent data of one outer iteration (cholesky mode).

    U (N,9,9), V (M,3,3), W (K,9,3), g_cams (N,9), g_pts (M,3) = -(J^T f),
    max_colnorm_sq = max diag(J^T J); evals (M,3) >= 0 and evecs (M,3,3) of
    V, y0 = Q^T g_pts; pairA/pairB (27, R*Lrow) whitened coupling W Q at the
    pair members, diagG per camera band (27, N_i*w_i), row_pt/cam_pt the
    point of each slot (sentinel M), cam_unperm band order -> camera order.
    """

    U: torch.Tensor
    V: torch.Tensor
    W: torch.Tensor
    g_cams: torch.Tensor
    g_pts: torch.Tensor
    max_colnorm_sq: torch.Tensor
    evecs: torch.Tensor
    evals: torch.Tensor
    y0: torch.Tensor
    pairA: torch.Tensor
    pairB: torch.Tensor
    diagG: tuple
    row_pt: torch.Tensor
    cam_pt: tuple
    cam_unperm: torch.Tensor


def _ext(P: torch.Tensor) -> torch.Tensor:
    """Append one zero column: (C, K) -> (C, K+1), so sentinel K gathers 0."""
    return torch.cat([P, P.new_zeros((P.shape[0], 1))], dim=1)


def planar_table_sum(P, table, budget_bytes: int = 64 << 20):
    """out[:, s] = sum_l P[:, table[s, l]] for (C, K) planar rows and an
    (S, L) gather table with sentinel K; L is chunked to bound the gathered
    (C, S, chunk) intermediate."""
    c, _ = P.shape
    s, l = table.shape
    P_ext = _ext(P)
    chunk = max(64, budget_bytes // max(c * s * P.element_size(), 1))
    out = P_ext[:, table[:, :chunk]].sum(dim=2)
    for lo in range(chunk, l, chunk):
        out = out + P_ext[:, table[:, lo:lo + chunk]].sum(dim=2)
    return out


def banded_planar_sum(P, banded, budget_bytes: int = 64 << 20):
    """planar_table_sum over a BandedTable; (C, S) in natural segment order."""
    outs = [planar_table_sum(P, t, budget_bytes) for t in banded.tables]
    return torch.cat(outs, dim=1)[:, banded.unperm]


def banded_planar_gram(P, banded, budget_bytes: int = 128 << 20):
    """Per-segment gram M[s][c][d] = sum_{slots, r} P[r, c, k] P[r, d, k].

    ``P`` is (R, C, K) planar row blocks. The C(C+1)/2 symmetric products
    are formed once in planar (C(C+1)/2, K) form and reduced with the banded
    table sum. Returns (S, C, C) in natural segment order."""
    _, c, _ = P.shape
    iu, ju = (torch.from_numpy(a).to(P.device) for a in np.triu_indices(c))
    prod = (P[:, iu, :] * P[:, ju, :]).sum(dim=0)  # (C(C+1)/2, K)
    sums = banded_planar_sum(prod, banded, budget_bytes).T  # (S, C(C+1)/2)
    out = P.new_zeros((sums.shape[0], c, c))
    out[:, iu, ju] = sums
    out[:, ju, iu] = sums
    return out


def point_coupling_sum(W, dxc, cam_idx, problem):
    """t[p] = sum_{k in p} W_k^T dxc[cam_k], (M, 3) in natural order."""
    Wdx = torch.einsum("kij,ki->kj", W, dxc[cam_idx])  # (K, 3)
    return banded_planar_sum(Wdx.T, problem.pt_banded).T


def _gather_pair_stacks(C_ext, problem):
    """Lambda-independent gathers of planar (27, K+1) coupling components
    into the pair tables and the per-band camera tables."""
    pairs, cam_banded = problem.pairs, problem.cam_banded
    pairA = C_ext[:, pairs.row_a.reshape(-1)]  # (27, R*Lrow)
    pairB = C_ext[:, pairs.row_b.reshape(-1)]
    diagG = tuple(C_ext[:, t.reshape(-1)] for t in cam_banded.tables)
    return (pairA, pairB, diagG, pairs.row_pt, tuple(cam_banded.aux),
            cam_banded.unperm)


def build_context(blocks: JacobianBlocks, problem, mode: str,
                  mm_dtype=None) -> SchurContext:
    """Normal-equation blocks and the cached pair-gram stacks from J.

    ``mm_dtype``: dtype of the cached pair stacks that feed the per-trial
    gram (float32 on the df32 drive); None = the blocks' dtype. The 3x3
    eigendecomposition of V runs in float64 and is cast back."""
    check_mode(mode)
    if problem.pairs is None or problem.cam_banded is None \
            or problem.pt_banded is None:
        raise NotImplementedError(
            "problems without pair and banded tables need the chunked dense "
            "gram, which is not ported yet"
        )
    pt_idx = problem.obs.pt_idx
    m = problem.n_points
    Jc, Jp, f = blocks.Jc, blocks.Jp, blocks.f
    k = Jc.shape[0]

    # Planar (rows, comps, K) blocks with the residual as the last
    # component: each banded gram's last column is the gradient.
    f_pl = f.T.reshape(2, 1, k)
    Jc10 = torch.cat([Jc.reshape(k, 18).T.reshape(2, 9, k), f_pl], dim=1)
    Jp4 = torch.cat([Jp.reshape(k, 6).T.reshape(2, 3, k), f_pl], dim=1)
    M10 = banded_planar_gram(Jc10, problem.cam_banded)
    M4 = banded_planar_gram(Jp4, problem.pt_banded)
    U, g_cams = M10[:, :9, :9], -M10[:, :9, 9]
    V, g_pts = M4[:, :3, :3], -M4[:, :3, 3]
    W = torch.einsum("kri,krj->kij", Jc, Jp)  # (K, 9, 3)
    max_colnorm_sq = torch.maximum(
        torch.diagonal(U, dim1=-2, dim2=-1).max(),
        torch.diagonal(V, dim1=-2, dim2=-1).max(),
    )

    evals64, evecs64 = linalg.eigh3x3_sym(V.to(torch.float64))
    evals = torch.clamp(evals64, min=0.0).to(V.dtype)
    evecs = evecs64.to(V.dtype)
    y0 = torch.einsum("mji,mj->mi", evecs, g_pts)  # Q^T g per point

    # Whitened coupling WQ27[3i+c] = sum_j W[k][i][j] Q[pt_k][j][c], planar.
    sd = mm_dtype or Jc.dtype
    W9 = W.reshape(k, 27).T.reshape(9, 3, k)
    Q9 = evecs.reshape(m, 9).T[:, pt_idx].reshape(3, 3, k)
    WQ27 = (W9[:, :, None, :] * Q9[None]).sum(dim=1).reshape(27, k).to(sd)
    pairA, pairB, diagG, row_pt, cam_pt, cam_unperm = _gather_pair_stacks(
        _ext(WQ27), problem)
    return SchurContext(
        U=U, V=V, W=W, g_cams=g_cams, g_pts=g_pts,
        max_colnorm_sq=max_colnorm_sq, evecs=evecs, evals=evals, y0=y0,
        pairA=pairA, pairB=pairB, diagG=diagG, row_pt=row_pt, cam_pt=cam_pt,
        cam_unperm=cam_unperm,
    )


def initial_lambda(ctx: SchurContext, mode: str) -> torch.Tensor:
    """cholesky: 1e-12 * max diag(J^T J) (BacktrackLevMarqCholesky.h:263-265)."""
    check_mode(mode)
    return 1e-12 * ctx.max_colnorm_sq


def _pair_gram_cached(ctx, lam, pairs, n: int, mm):
    """(S_sum (9N, 9N), b_sum (N, 9)) of sum W (V + lam I)^-1 W^T from the
    cached stacks: weights 1/(evals + lam) gathered per slot."""
    sd = ctx.pairA.dtype
    winv = 1.0 / (ctx.evals + lam)  # (M, 3)
    w_ext = _ext(winv.T.to(sd))
    py_ext = _ext((winv * ctx.y0).T.to(sd))
    return _pair_gram_tables(ctx, w_ext, py_ext, pairs, n, mm)


def _pair_gram_tables(ctx, w_ext, py_ext, pairs, n: int, acc):
    """Weighted pair gram over the cached stacks: strictly-upper pair
    blocks, per-camera diagonal blocks and rhs, summed per camera key and
    placed in the dense (9N, 9N) matrix by one gather."""
    r, l_row = ctx.row_pt.shape
    wflat = w_ext[:, ctx.row_pt.reshape(-1)].to(acc)  # (3, R*L)
    A4 = ctx.pairA.to(acc).reshape(9, 3, r, l_row)
    B4 = ctx.pairB.to(acc).reshape(9, 3, r, l_row)
    O = torch.einsum("icrl,crl,jcrl->ijr", A4, wflat.reshape(3, r, l_row),
                     B4).reshape(81, r)

    md_parts, b_parts = [], []
    for G, cp in zip(ctx.diagG, ctx.cam_pt):
        nb, lb = cp.shape
        wd = w_ext[:, cp.reshape(-1)].to(acc).reshape(3, nb, lb)
        pyg = py_ext[:, cp.reshape(-1)].to(acc)
        G4 = G.to(acc).reshape(9, 3, nb, lb)
        md = torch.einsum("icnl,cnl,jcnl->ijn", G4, wd, G4)  # (9, 9, Nb)
        md_parts.append(md.permute(2, 0, 1))
        bq = (G4.reshape(9, 3, nb * lb) * pyg[None]).sum(dim=1)  # (9, Nb*Lb)
        b_parts.append(bq.reshape(9, nb, lb).sum(dim=2).T)  # (Nb, 9)
    Mdiag = torch.cat(md_parts)[ctx.cam_unperm]  # (N, 9, 9)
    b_sum = torch.cat(b_parts)[ctx.cam_unperm]  # (N, 9)

    key_sums = _ext(O)[:, pairs.key_table].sum(dim=2)  # (81, KO)
    up4 = _ext(key_sums)[:, pairs.key_to_obs].reshape(9, 9, n, n)
    full4 = up4 + up4.permute(1, 0, 3, 2)
    eye = torch.eye(n, dtype=acc, device=O.device)
    full4 = full4 + Mdiag.permute(1, 2, 0)[..., None] * eye
    S_sum = full4.permute(2, 0, 3, 1).reshape(9 * n, 9 * n)
    return S_sum, b_sum


def assemble_reduced(S_sum, b_sum, ctx, lam, n: int):
    """S = blkdiag(U + lam I) - S_sum, b = g_cams - b_sum."""
    dtype = ctx.U.dtype
    S = -S_sum.to(dtype)
    eye9 = torch.eye(9, dtype=dtype, device=S.device)
    diag = torch.diagonal(S.view(n, 9, n, 9), dim1=0, dim2=2)  # (9, 9, N) view
    diag.add_((ctx.U + lam * eye9).permute(1, 2, 0))
    b = ctx.g_cams.reshape(-1) - b_sum.reshape(-1).to(dtype)
    return S, b


def _camera_solve_chol(S, b):
    """Solve the reduced camera system S x = b (the SimplicialLDLT analog).

    Jacobi scaling D S D with D = diag(S)^-1/2. A float64 system is solved
    by QR. A float32 system is factored once by Cholesky in float32 and
    refined twice with float64 residuals b - S x (S promoted to float64);
    if the Cholesky breaks down (the Schur subtraction can leave S
    indefinite at the 1e-10 level for tiny lambda) the refinement runs on a
    QR of the scaled system instead. Returns x in S's dtype."""
    in_dtype = S.dtype
    f64 = torch.float64
    S64, b64 = S.to(f64), b.to(f64)
    d = torch.diagonal(S64)
    dinv = torch.where(
        d > 0, torch.rsqrt(d.abs() + torch.finfo(f64).tiny),
        torch.ones_like(d))
    Ss64 = S64 * dinv[:, None] * dinv[None, :]

    if in_dtype == f64:
        Q, R = torch.linalg.qr(Ss64)
        y = torch.linalg.solve_triangular(
            R, (Q.T @ (b64 * dinv))[:, None], upper=True)[:, 0]
        return y * dinv

    Ss32 = Ss64.to(in_dtype)
    L, info = torch.linalg.cholesky_ex(Ss32)
    if bool((info == 0) & torch.isfinite(L).all()):
        def solve32(r64):
            r = r64.to(in_dtype)[:, None]
            return torch.cholesky_solve(r, L)[:, 0].to(f64)
    else:
        Q, R = torch.linalg.qr(Ss32)

        def solve32(r64):
            r = (Q.T @ r64.to(in_dtype))[:, None]
            return torch.linalg.solve_triangular(R, r, upper=True)[:, 0].to(f64)

    x = solve32(b64 * dinv) * dinv
    for _ in range(2):
        r = b64 - S64 @ x
        x = x + solve32(r * dinv) * dinv
    return x.to(in_dtype)


def _point_factor_inv(ctx: SchurContext, lam, dtype):
    """Linv (M,3,3) with (V + lam I)^-1 = Linv^T Linv: clamped closed-form
    3x3 Cholesky in float64, cast to ``dtype``."""
    f64 = torch.float64
    eye3 = torch.eye(3, dtype=f64, device=ctx.V.device)
    L = linalg.cholesky3x3(ctx.V.to(f64) + lam * eye3, clamp=True)
    return linalg.inv_lower3x3(L).to(dtype)


def solve_damped(ctx: SchurContext, lam: float, problem, mode: str,
                 mm_dtype=None):
    """Solve (J^T J + lam I) dx = -J^T f; returns (dx_pts (M,3), dx_cams (N,9)).

    ``lam`` is a Python float already rounded to the context's dtype by
    the caller; ``mm_dtype`` must be the value ``build_context`` used."""
    check_mode(mode)
    n = problem.n_cameras
    dtype = ctx.U.dtype
    mm = mm_dtype or dtype
    S_sum, b_sum = _pair_gram_cached(ctx, lam, problem.pairs, n, mm)
    S, b = assemble_reduced(S_sum, b_sum, ctx, lam, n)
    dxc = _camera_solve_chol(S, b).reshape(n, 9)
    t = ctx.g_pts - point_coupling_sum(ctx.W, dxc, problem.obs.cam_idx, problem)
    Linv = _point_factor_inv(ctx, lam, dtype)
    y = torch.einsum("mij,mj->mi", Linv, t)
    dxp = torch.einsum("mji,mj->mi", Linv, y)
    return dxp, dxc


def gradient_dot(ctx: SchurContext, dxp, dxc, lam: float) -> torch.Tensor:
    """rhoScale = dx^T (lam dx + JtRes) (BacktrackLevMarqCholesky.h:300), as
    a float64 0-dim tensor. float32 steps are summed in float32 and the sums
    promoted (both terms are positive: no cancellation)."""
    f64 = torch.float64

    def dsum(a, b):
        return (a * b).sum().to(f64)

    jtres_dot = dsum(dxc, ctx.g_cams.to(dxc.dtype)) + dsum(
        dxp, ctx.g_pts.to(dxp.dtype))
    dx_norm2 = dsum(dxc, dxc) + dsum(dxp, dxp)
    return lam * dx_norm2 + jtres_dot

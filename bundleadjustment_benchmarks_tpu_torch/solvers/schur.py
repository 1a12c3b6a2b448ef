"""Damped-system solvers: five strategies on one Schur-complement engine.

The damped normal equations (J^T J + lam I) dx = -J^T f of bundle adjustment
are solved by eliminating the 3x3 point blocks. The reference compiles five
binaries around five sparse factorizations of that system (SURVEY.md
section 0); here each is a (point factor, camera solver) pair:

  mode       point factor   camera solver
  cholesky   chol           chol       (BacktrackLevMarqCholesky.h:272-282)
  qrchol     qr             chol       (BacktrackLevMarqQRChol.h:286-341)
  qrkit      qr             qr_cached  (BAFunctor.h:98-102 + More's re-damp)
  spqr       qr             qr_full    (SuiteSparse QR per trial,
                                        BAFunctor.h:114-116)
  moreqr     eig            chol       (BacktrackLevMarqMore.h:287-328)

  * point factor ``chol``: clamped closed-form Cholesky of V + lam I in
    float64; ``qr``: batched MGS QR of each point's stacked observation rows
    augmented with sqrt(lam) I3 (no squaring); ``eig``: V = Q diag(e) Q^T
    once per outer iteration, (e + lam)^-1 per trial.
  * camera solver ``chol``: S = blkdiag(U + lam I) - sum W (V + lam I)^-1 W^T
    and its Jacobi-scaled solve. With pair tables S comes from the cached
    observation-pair stacks of W Q weighted by 1/(e + lam); without them
    (every point seen once) from a chunked dense gram.
  * ``qr_cached`` (qrkit): one lambda-free factorization per outer
    iteration, a cheap re-damp per trial. With pair tables the cache is
    the projected cross rows compressed to per-observation blocks B in the
    pair tables plus the lambda-free reduced system S0 ("pair"); without
    them, the dense cross rows QtRpc and the camera factor Rcc_aug,
    re-damped by a row-QR ("rows"). The problem decides: on an H100 at
    p257, "pair" re-damps 34-50x faster in a quarter of the memory.
    ``_qrkit_gram_camera_step`` (the rows cache re-damped in gram form)
    is the JAX package's TPU path, kept for the parity tests.
  * ``qr_full`` (spqr): the whole augmented matrix re-factored every trial,
    in R-only CholeskyQR form: the gram of the projected camera rows
    (``camera_solve_qr``). ``_camera_solve_tsqr``, the Householder TSQR of
    the same rows, is the parity tests' reference: on an H100 it takes
    ~100x longer per p257 trial.

The qr_cached identity: after the lambda-free QR of [J | b], the damped
camera system's gram is
    S(lam) = Rcc^T Rcc + lam I + lam Rpc^T (Rpp Rpp^T + lam I)^-1 Rpc,
so with Rpp Rpp^T = Qh diag(eh) Qh^T the fill-in of eliminating the damped
point columns is exactly the rows sqrt(lam/(eh+lam)) Qh^T Rpc: a diagonal
rescaling of the cached QtRpc.

``build_context`` runs once per outer LM iteration, ``solve_damped`` once
per damping trial. lambda is a Python float (the host LM drive) or a 0-dim
float64 tensor on the problem's device (the device-resident drive, which
captures the trial into a CUDA graph); both give the same arithmetic, bit
for bit (``_sqrt``, ``_redamp_scale``). Both take a ``Reduce``: on one device (``LOCAL``) it does
nothing; on a shard (``parallel/sharded.py``) it all-reduces the partial
sums that the rank's slice of the points contributes to camera-sized totals.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph, linalg
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

#: Points per chunk of the reference TSQR, and rows per chunk of qrkit's
#: row-QR re-damp: the JAX package's chunk sizes.
TSQR_CHUNK_POINTS = 512
REDAMP_CHUNK_ROWS = 12288


def check_mode(mode: str) -> None:
    """Raise unless ``mode`` is one of MODES."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


class Reduce:
    """How one rank's partial results become the whole problem's.

    The solver sums over observations and points. Where a rank holds only
    a slice of the points (``parallel/sharded.py``), the sums that land in
    camera-sized totals (U, g_cams, the reduced system, the camera grams)
    and the scalars (energies, rho's point terms) are partial, and so is
    the max of diag(V). This class, the single-device case (``LOCAL``),
    returns them as they are; the sharded subclass all-reduces them.
    ``points`` maps the rank's (M_rank, 3) points to all (M, 3)."""

    #: True where the ranks hold slices: qrkit without pair tables then
    #: re-damps in gram form, which sums over points (see
    #: _camera_solve_qr_cached).
    sharded = False
    rank = 0

    def sum(self, *ts):
        """The totals of partial sums, as a tuple (in place where it can)."""
        return ts

    def max(self, t):
        return t

    def points(self, pts):
        return pts


LOCAL = Reduce()


@dataclasses.dataclass
class SchurContext:
    """Lambda-independent data of one outer iteration.

    Always: U (N,9,9), V (M,3,3), W (K,9,3), g_cams (N,9), g_pts (M,3) =
    -(J^T f), max_colnorm_sq = max diag(J^T J). The rest is set by mode:
      * ``qr`` point factor: Jp_stacked (M, 2 Lmax, 3) observation rows per
        point (zero rows for padding); spqr and qrkit without pair tables
        also Jc_stacked (M, 2 Lmax, 9) and rhs_stacked (M, 2 Lmax) = -f,
        in the matmul dtype.
      * eigenbasis (moreqr, and the chol camera solver with pair tables):
        evals (M,3) >= 0, evecs (M,3,3) of V, y0 = Q^T g_pts; without pair
        tables, moreqr's WQ (K,9,3) = W Q in the matmul dtype.
      * pair stacks (chol camera solver or qrkit, with pair tables):
        pairA/pairB (27, R*Lrow) planar coupling at the pair members (W Q,
        or qrkit's B), diagG per camera band (27, N_i*w_i), row_pt/cam_pt
        the point of each slot (sentinel M), cam_unperm band order ->
        camera order.
      * qrkit: fill_evals (M,3) >= 0, eigenvalues of Rpp Rpp^T; with pair
        tables qr_cqT (3, M) rhs rows, qr_S0cam (9N, 9N) = blkdiag(U) -
        sum B^T B and qr_b0 (9N,); without them QtRpc (M, 3, 9N+1) =
        Qh^T Q1^T [A_cam | b] and Rcc_aug (9N+1, 9N+1), the lambda-free
        camera factor.
    """

    U: torch.Tensor
    V: torch.Tensor
    W: torch.Tensor
    g_cams: torch.Tensor
    g_pts: torch.Tensor
    max_colnorm_sq: torch.Tensor
    Jp_stacked: Optional[torch.Tensor] = None
    Jc_stacked: Optional[torch.Tensor] = None
    rhs_stacked: Optional[torch.Tensor] = None
    evecs: Optional[torch.Tensor] = None
    evals: Optional[torch.Tensor] = None
    WQ: Optional[torch.Tensor] = None
    y0: Optional[torch.Tensor] = None
    pairA: Optional[torch.Tensor] = None
    pairB: Optional[torch.Tensor] = None
    diagG: Optional[tuple] = None
    row_pt: Optional[torch.Tensor] = None
    cam_pt: Optional[tuple] = None
    cam_unperm: Optional[torch.Tensor] = None
    QtRpc: Optional[torch.Tensor] = None
    fill_evals: Optional[torch.Tensor] = None
    Rcc_aug: Optional[torch.Tensor] = None
    qr_cqT: Optional[torch.Tensor] = None
    qr_S0cam: Optional[torch.Tensor] = None
    qr_b0: Optional[torch.Tensor] = None


def _sqrt(lam):
    """sqrt(lambda) in float64: math.sqrt of a float, torch.sqrt of a 0-dim
    tensor (both correctly rounded, so the two agree bit for bit)."""
    if torch.is_tensor(lam):
        return torch.sqrt(lam.to(torch.float64))
    return math.sqrt(lam)


def _ext(P: torch.Tensor) -> torch.Tensor:
    """Append one zero column: (C, K) -> (C, K+1), so sentinel K gathers 0."""
    return torch.cat([P, P.new_zeros((P.shape[0], 1))], dim=1)


def _ext0(x: torch.Tensor) -> torch.Tensor:
    """Append one zero row along dim 0, so sentinel len(x) gathers 0."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def _add_blockdiag(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S (9N, 9N) += blkdiag(blocks (N, 9, 9)), in place; returns S."""
    n = blocks.shape[0]
    diag = torch.diagonal(S.view(n, 9, n, 9), dim1=0, dim2=2)  # (9, 9, N)
    diag.add_(blocks.permute(1, 2, 0))
    return S


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


#: (c, device) -> the upper-triangle index pair, made once per device (a
#: host-to-device copy cannot run inside a CUDA graph capture).
_TRIU: dict = {}


def _triu_indices(c: int, device):
    key = (c, str(device))
    if key not in _TRIU:
        _TRIU[key] = tuple(torch.from_numpy(a).to(device)
                           for a in np.triu_indices(c))
    return _TRIU[key]


def banded_planar_gram(P, banded, budget_bytes: int = 128 << 20):
    """Per-segment gram M[s][c][d] = sum_{slots, r} P[r, c, k] P[r, d, k].

    ``P`` is (R, C, K) planar row blocks. The C(C+1)/2 symmetric products
    are formed once in planar (C(C+1)/2, K) form and reduced with the banded
    table sum. Returns (S, C, C) in natural segment order."""
    _, c, _ = P.shape
    iu, ju = _triu_indices(c, P.device)
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


# -- the chunked dense gram (problems without pair tables) ---------------------


def _gram_chunk_size(n_cameras: int, n_points: int,
                     budget_bytes: int = 256 << 20) -> int:
    """Points per chunk so that a chunk's dense Z rows stay under budget."""
    per_point = n_cameras * 9 * 3 * 4  # float32 Z rows of one point
    return max(256, min(n_points, budget_bytes // max(per_point, 1)))


def _schur_gram_chunked(C, w, y, cam_idx, table, n_cameras: int, mm):
    """S_sum = Z^T diag(w) Z and b_sum = Z^T (w y) without the whole Z.

    Z's three rows of point p hold C_k^T (3, 9) of p's observations at
    their cameras' block columns. Points go in chunks through the (M, Lmax)
    point table (sentinel K gathers a zero block); each chunk's rows are
    placed in a (P, N, 3, 9) buffer by an accumulating index_put_ and feed
    one matmul.

    C (K, 9, 3) coupling blocks; w (M, 3) row weights or None; y (M, 3)
    rhs rows. Returns (S_sum (9N, 9N), b_sum (9N,)) in ``mm``."""
    m, lmax = table.shape
    n9 = 9 * n_cameras
    chunk = _gram_chunk_size(n_cameras, m)
    CT_ext = _ext0(C.to(mm)).transpose(1, 2)  # (K+1, 3, 9)
    cam_ext = _ext0(cam_idx).long()
    y = y.to(mm)
    w = None if w is None else w.to(mm)
    S = C.new_zeros((n9, n9), dtype=mm)
    b = C.new_zeros((n9,), dtype=mm)
    for lo in range(0, m, chunk):
        tbl = table[lo:lo + chunk].long()
        p = tbl.shape[0]
        slot_pt = torch.arange(p, device=tbl.device).repeat_interleave(lmax)
        Zc = C.new_zeros((p, n_cameras, 3, 9), dtype=mm)
        Zc.index_put_((slot_pt, cam_ext[tbl].reshape(-1)),
                      CT_ext[tbl.reshape(-1)], accumulate=True)
        Zc = Zc.transpose(1, 2).reshape(p * 3, n9)
        yc = y[lo:lo + chunk]
        if w is None:
            Zw, yw = Zc, yc
        else:
            wc = w[lo:lo + chunk]
            Zw, yw = Zc * wc.reshape(-1)[:, None], yc * wc
        S += Zc.T @ Zw
        b += Zc.T @ yw.reshape(-1)
    return S, b


# -- the cached pair gram (chol camera solver, qrkit "pair") ------------------


def _gather_pair_stacks(C_ext, problem):
    """Lambda-independent gathers of planar (27, K+1) coupling components
    into the pair tables and the per-band camera tables."""
    pairs, cam_banded = problem.pairs, problem.cam_banded
    return dict(
        pairA=C_ext[:, pairs.row_a.reshape(-1)],  # (27, R*Lrow)
        pairB=C_ext[:, pairs.row_b.reshape(-1)],
        diagG=tuple(C_ext[:, t.reshape(-1)] for t in cam_banded.tables),
        row_pt=pairs.row_pt, cam_pt=tuple(cam_banded.aux),
        cam_unperm=cam_banded.unperm)


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
    placed in the dense (9N, 9N) matrix by one gather. Serves the chol
    camera solver (stacks W Q, w = 1/(evals + lam)) and qrkit with pair
    tables (stacks B, w = lam/(fill_evals + lam), or 1 for S0)."""
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
    eye9 = torch.eye(9, dtype=dtype, device=ctx.U.device)
    S = _add_blockdiag(-S_sum.to(dtype), ctx.U + lam * eye9)
    b = ctx.g_cams.reshape(-1) - b_sum.reshape(-1).to(dtype)
    return S, b


# -- qrkit: the lambda-free camera factorization ------------------------------


def _cam_per_slot(problem):
    """(M, Lmax) camera of each point-table slot (sentinel -> camera 0,
    whose row data is zero for padded slots)."""
    return _ext0(problem.obs.cam_idx)[problem.pt_obs_idx]


def _point_row_blocks(Q1, Jc_stacked, rhs_stacked, Qh=None):
    """Per-slot projected camera blocks and rhs rows of the left point QR:
        B[m, l] = Qh_m^T Q1[m, 2l:2l+2]^T Jc_stacked[m, 2l:2l+2]   (3, 9)
        c[m]    = Qh_m^T Q1_obs[m]^T rhs_stacked[m]                (3,)
    the rows Rpc = Q1^T [A_cam | b] split by observed camera, optionally
    rotated into the Qh eigenbasis. Q1's trailing lambda rows (if any) meet
    zero camera columns and a zero rhs, so only observation rows count."""
    m_pts, two_l, _ = Jc_stacked.shape
    lmax = two_l // 2
    Q1o = Q1[:, :two_l, :].reshape(m_pts, lmax, 2, 3)
    Jc4 = Jc_stacked.reshape(m_pts, lmax, 2, 9)
    B = torch.einsum("mlrc,mlrj->mlcj", Q1o, Jc4)  # (M, Lmax, 3, 9)
    c = torch.einsum("mlrc,mlr->mc", Q1o, rhs_stacked.reshape(m_pts, lmax, 2))
    if Qh is not None:
        B = torch.einsum("mdc,mldj->mlcj", Qh, B)
        c = torch.einsum("mdc,md->mc", Qh, c)
    return B, c


def _place_rows(B, c, cam_per_slot, n_cameras: int, dtype,
                chunk: int = 8192):
    """Dense rows (M, 3, 9N+1): each slot's (3, 9) block at its camera's
    block columns (a scatter-add along the columns, chunked over points to
    bound the index tensor), the rhs rows in the last column."""
    m_pts, lmax = cam_per_slot.shape
    rows = B.new_zeros((m_pts, 3, 9 * n_cameras + 1), dtype=dtype)
    j9 = torch.arange(9, device=B.device)
    for lo in range(0, m_pts, chunk):
        cams = cam_per_slot[lo:lo + chunk].long()
        p = cams.shape[0]
        cols = (9 * cams[:, :, None] + j9).reshape(p, 1, lmax * 9)
        src = B[lo:lo + chunk].to(dtype).permute(0, 2, 1, 3)
        rows[lo:lo + chunk].scatter_add_(2, cols.expand(p, 3, lmax * 9),
                                         src.reshape(p, 3, lmax * 9))
    rows[:, :, -1] = c.to(dtype)
    return rows


def _aug_camera_gram(U, g_cams, energy, dtype):
    """Gram of the augmented camera rows [A_cam | b]: blkdiag(U) with the
    gradient as rhs column and b^T b = ||f||^2 in the corner."""
    n = U.shape[0]
    n9 = 9 * n
    Ua = U.new_zeros((n9 + 1, n9 + 1), dtype=dtype)
    top = Ua[:n9, :n9].view(n, 9, n, 9)
    torch.diagonal(top, dim1=0, dim2=2).copy_(U.permute(1, 2, 0))
    g = g_cams.reshape(-1).to(dtype)
    Ua[:n9, n9] = g
    Ua[n9, :n9] = g
    # In place on the device (no host copy of a Python number).
    if torch.is_tensor(energy):
        Ua[n9, n9].copy_(energy)
    else:
        Ua[n9, n9].fill_(energy)
    return Ua


def _gram_sqrt_factor(S):
    """Rows C with C^T C ~= S for symmetric S, PSD up to rounding, by a
    Jacobi-scaled eigendecomposition with the eigenvalues clamped at 0 (the
    Schur subtraction leaves eps-level indefiniteness that a Cholesky would
    turn into NaN). Any such row set serves the row-QR that follows."""
    d = torch.diagonal(S)
    dinv = torch.where(d > 0, torch.rsqrt(d.abs() + torch.finfo(S.dtype).tiny),
                       torch.ones_like(d))
    Ss = S * dinv[:, None] * dinv[None, :]
    w, V = torch.linalg.eigh((Ss + Ss.T) / 2)
    C = torch.sqrt(torch.clamp(w, min=0.0))[:, None] * V.T
    return C / dinv[None, :]


def _rpp_eigenbasis(Jp_stacked, f_dtype):
    """Rank-guarded MGS QR of the lambda-free point stacks and the
    eigenbasis of Rpp Rpp^T (float64): (Q1_0, Rpp, fill_evals, Qh)."""
    Q1_0, Rpp = linalg.mgs_qr3(Jp_stacked, zero_deficient=True)
    eh, Qh64 = linalg.eigh3x3_sym(
        torch.einsum("mij,mkj->mik", Rpp, Rpp).to(torch.float64))
    fill_evals = torch.clamp(eh, min=0.0).to(f_dtype)
    return Q1_0, Rpp, fill_evals, Qh64.to(Jp_stacked.dtype)


def _qrkit_row_cache(ctx, blocks, problem, mm, reduce):
    """qrkit without pair tables: QtRpc = Qh^T Q1_0^T [A_cam | b] placed
    densely, and Rcc_aug, the gram square root of U_aug - QtRpc^T QtRpc."""
    n, m = problem.n_cameras, problem.n_points
    f = blocks.f
    Q1_0, _, ctx.fill_evals, Qh = _rpp_eigenbasis(ctx.Jp_stacked, f.dtype)
    Bq, cq = _point_row_blocks(Q1_0, ctx.Jc_stacked, ctx.rhs_stacked, Qh=Qh)
    ctx.QtRpc = _place_rows(Bq, cq, _cam_per_slot(problem), n, mm)
    flat = ctx.QtRpc.reshape(3 * m, 9 * n + 1)
    f_mm = f.to(mm)
    G, ff = reduce.sum(flat.T @ flat, (f_mm * f_mm).sum())
    # The rhs column carries b = -f, whose camera gram column is g_cams.
    ctx.Rcc_aug = _gram_sqrt_factor(
        _aug_camera_gram(ctx.U, ctx.g_cams, ff, mm) - G).to(mm)


def _qrkit_pair_cache(ctx, blocks, problem, reduce):
    """qrkit with pair tables: with Q1_0 = Jp_stacked Rpp^-1, each observation's
    projected camera block is B_k = P_p W_k^T with P_p = Qh_p^T Rpp_p^-T
    (rank-guarded: zero rows for zeroed pivots), so the cache is the planar
    (27, K) B gathered into the pair tables, the rhs rows cq = P g_pts, and
    S0 = blkdiag(U) - sum B^T B, b0 = g_cams - sum B^T cq."""
    n, m = problem.n_cameras, problem.n_points
    f, W = blocks.f, ctx.W
    k = W.shape[0]
    _, Rpp, ctx.fill_evals, Qh = _rpp_eigenbasis(ctx.Jp_stacked, f.dtype)
    ok = torch.diagonal(Rpp, dim1=-2, dim2=-1) > 0  # (M, 3)
    patch = torch.where(ok, 0.0, 1.0).to(Rpp.dtype)
    eye3 = torch.eye(3, dtype=Rpp.dtype, device=Rpp.device)
    RinvT = linalg.inv_lower3x3(Rpp.transpose(-1, -2) + patch[..., :, None] * eye3)
    RinvT = torch.where(ok[..., None], RinvT, torch.zeros_like(RinvT))
    Pm = torch.einsum("mdc,mdj->mcj", Qh, RinvT)  # (M, 3, 3)
    cq = torch.einsum("mcj,mj->mc", Pm, ctx.g_pts)
    # B27[3j+c, k] = sum_t P_p[c, t] W_k[j, t].
    W9 = W.reshape(k, 27).T.reshape(9, 3, k)
    P9 = Pm.reshape(m, 9).T[:, problem.obs.pt_idx].reshape(3, 3, k)
    B27 = (W9[:, None, :, :] * P9[None]).sum(dim=2).reshape(27, k).to(f.dtype)
    for name, v in _gather_pair_stacks(_ext(B27), problem).items():
        setattr(ctx, name, v)
    ctx.qr_cqT = cq.T.to(f.dtype)
    ones = torch.ones((3, m), dtype=f.dtype, device=f.device)
    S_sum0, b_sum0 = reduce.sum(*_pair_gram_tables(
        ctx, _ext(ones), _ext(ctx.qr_cqT), problem.pairs, n, f.dtype))
    ctx.qr_S0cam = _add_blockdiag(-S_sum0.to(f.dtype), ctx.U.to(f.dtype))
    ctx.qr_b0 = ctx.g_cams.reshape(-1).to(f.dtype) - b_sum0.reshape(-1)


def build_context(blocks: JacobianBlocks, problem, mode: str,
                  mm_dtype=None, reduce: Reduce = LOCAL) -> SchurContext:
    """Normal-equation blocks and the mode's lambda-free cache from J.

    ``mm_dtype``: dtype of the large cached operands (the pair stacks, the
    stacked camera rows, qrkit's QtRpc/Rcc_aug; float32 on the df32 drive);
    None = the blocks' dtype. The 3x3 eigendecompositions run in float64.
    The chol camera solver and qrkit use the problem's pair tables where it
    has them (``problem.pairs``), and the dense forms where it has none.
    ``reduce`` totals U, g_cams, the max column norm and qrkit's lambda-free
    camera system over the ranks (see Reduce)."""
    check_mode(mode)
    if problem.cam_banded is None or problem.pt_banded is None:
        raise ValueError("the problem has no banded segment tables "
                         "(models.problem.from_bal_dataset builds them)")
    point_factor, camera_solver = MODE_STRATEGY[mode]
    pairs = problem.pairs
    pt_idx = problem.obs.pt_idx
    m = problem.n_points
    Jc, Jp, f = blocks.Jc, blocks.Jp, blocks.f
    k = Jc.shape[0]

    # Planar (rows, comps, K) blocks with the residual as the last
    # component: each banded gram's last column is the gradient.
    f_pl = f.T.reshape(2, 1, k)
    Jc10 = torch.cat([Jc.reshape(k, 18).T.reshape(2, 9, k), f_pl], dim=1)
    Jp4 = torch.cat([Jp.reshape(k, 6).T.reshape(2, 3, k), f_pl], dim=1)
    (M10,) = reduce.sum(banded_planar_gram(Jc10, problem.cam_banded))
    M4 = banded_planar_gram(Jp4, problem.pt_banded)
    U, V = M10[:, :9, :9], M4[:, :3, :3]
    ctx = SchurContext(
        U=U, V=V, W=torch.einsum("kri,krj->kij", Jc, Jp),  # (K, 9, 3)
        g_cams=-M10[:, :9, 9], g_pts=-M4[:, :3, 3],
        max_colnorm_sq=torch.maximum(
            torch.diagonal(U, dim1=-2, dim2=-1).max(),
            reduce.max(torch.diagonal(V, dim1=-2, dim2=-1).max())),
    )
    mm = mm_dtype or Jc.dtype

    if point_factor == "qr":
        # Each point's observation rows in a padded stack; sentinel K
        # gathers a zero row, harmless in a QR.
        tbl = problem.pt_obs_idx
        lmax = tbl.shape[1]
        ctx.Jp_stacked = _ext0(Jp)[tbl].reshape(m, 2 * lmax, 3)
        if camera_solver == "qr_full" or (camera_solver == "qr_cached"
                                          and pairs is None):
            ctx.Jc_stacked = _ext0(Jc)[tbl].reshape(m, 2 * lmax, 9).to(mm)
            ctx.rhs_stacked = (-_ext0(f)[tbl]).reshape(m, 2 * lmax).to(mm)
        if camera_solver == "qr_cached":
            if pairs is not None:
                _qrkit_pair_cache(ctx, blocks, problem, reduce)
            else:
                _qrkit_row_cache(ctx, blocks, problem, mm, reduce)

    if point_factor == "eig" or (camera_solver == "chol" and pairs is not None):
        evals64, evecs64 = linalg.eigh3x3_sym(V.to(torch.float64))
        ctx.evals = torch.clamp(evals64, min=0.0).to(V.dtype)
        ctx.evecs = evecs64.to(V.dtype)
        ctx.y0 = torch.einsum("mji,mj->mi", ctx.evecs, ctx.g_pts)  # Q^T g

    if camera_solver == "chol" and pairs is not None:
        # Whitened coupling WQ27[3i+c] = sum_j W[k][i][j] Q[pt_k][j][c].
        W9 = ctx.W.reshape(k, 27).T.reshape(9, 3, k)
        Q9 = ctx.evecs.reshape(m, 9).T[:, pt_idx].reshape(3, 3, k)
        WQ27 = (W9[:, :, None, :] * Q9[None]).sum(dim=1).reshape(27, k).to(mm)
        for name, v in _gather_pair_stacks(_ext(WQ27), problem).items():
            setattr(ctx, name, v)
    elif point_factor == "eig":
        ctx.WQ = torch.einsum("kij,kjl->kil", ctx.W, ctx.evecs[pt_idx]).to(mm)
    return ctx


def initial_lambda(ctx: SchurContext, mode: str) -> torch.Tensor:
    """First-iteration lambda by each driver's rule: cholesky and qrchol
    1e-12 * max diag(J^T J) (BacktrackLevMarqCholesky.h:263-265,
    BacktrackLevMarqQRChol.h:276-280); moreqr 1e-6 * max column norm
    (BacktrackLevMarqMore.h:281-285), which qrkit and spqr share."""
    check_mode(mode)
    if mode in ("cholesky", "qrchol"):
        return 1e-12 * ctx.max_colnorm_sq
    return 1e-6 * torch.sqrt(ctx.max_colnorm_sq)


# -- per-trial solves -----------------------------------------------------------


def _camera_solve_chol(S, b):
    """Solve the reduced camera system S x = b (the SimplicialLDLT analog).

    Jacobi scaling D S D with D = diag(S)^-1/2. A float64 system is solved
    by QR. A float32 system is factored once by Cholesky in float32 and
    refined twice with float64 residuals b - S x (S promoted to float64);
    if the Cholesky breaks down (the Schur subtraction can leave S
    indefinite at the 1e-10 level for tiny lambda) the refinement runs on a
    QR of the scaled system instead. The breakdown test (``cholesky_ex``'s
    info == 0 and a finite factor) is a device predicate: the host drive on
    CUDA reads it once per float32 solve; under a CUDA graph capture both
    branches become conditional nodes (the JAX package's lax.cond), and on
    the CPU the predicate is read. Returns x in S's dtype."""
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
        return linalg.solve_upper_triangular(R, Q.T @ (b64 * dinv)) * dinv

    Ss32 = Ss64.to(in_dtype)
    L, info = torch.linalg.cholesky_ex(Ss32)
    ok = (info == 0) & torch.isfinite(L).all()

    def refined(solve32):
        x = solve32(b64 * dinv) * dinv
        for _ in range(2):
            r = b64 - S64 @ x
            x = x + solve32(r * dinv) * dinv
        return x.to(in_dtype)

    def by_cholesky():
        return refined(lambda r64: torch.cholesky_solve(
            r64.to(in_dtype)[:, None], L)[:, 0].to(f64))

    def by_qr():
        Q, R = torch.linalg.qr(Ss32)
        return refined(lambda r64: linalg.solve_upper_triangular(
            R, Q.T @ r64.to(in_dtype)).to(f64))

    if S.is_cuda and not cuda_graph.capturing():
        return by_cholesky() if bool(ok) else by_qr()
    return cuda_graph.device_cond(ok, by_cholesky, by_qr,
                                  torch.empty_like(b, dtype=in_dtype))


def _point_factor_inv(ctx: SchurContext, lam, mode: str, dtype):
    """Linv (M,3,3) with (V + lam I)^-1 = Linv^T Linv, cast to ``dtype``.

    ``chol``: clamped closed-form 3x3 Cholesky in float64. ``qr``: R of
    the MGS QR of [Jp_stacked; sqrt(lam) I3] in the stacks' dtype (no
    squaring), Linv = (R^T)^-1."""
    if MODE_STRATEGY[mode][0] == "chol":
        f64 = torch.float64
        eye3 = torch.eye(3, dtype=f64, device=ctx.V.device)
        L = linalg.cholesky3x3(ctx.V.to(f64) + lam * eye3, clamp=True)
        return linalg.inv_lower3x3(L).to(dtype)
    Js = ctx.Jp_stacked
    eye3 = torch.eye(3, dtype=Js.dtype, device=Js.device)
    lam_rows = (_sqrt(lam) * eye3).expand(Js.shape[0], 3, 3)
    _, R = linalg.mgs_qr3(torch.cat([Js, lam_rows], dim=1))
    return linalg.inv_lower3x3(R.transpose(-1, -2)).to(dtype)


def _redamp_scale(fill_evals, lam):
    """lam / (fill_evals + lam) in fill_evals' dtype (true division)."""
    lam_t = (lam.to(fill_evals.dtype) if torch.is_tensor(lam)
             else torch.full_like(fill_evals, lam))
    return lam_t / (fill_evals + lam_t)


def _redamp_qr(Rcc_aug, QtRpc, fill_evals, lam,
               chunk_rows: int = REDAMP_CHUNK_ROWS):
    """qrkit per-trial re-damp by row-QR of
        [Rcc_aug; sqrt(lam/(eh+lam)) QtRpc; sqrt(lam) I_9N | 0],
    the exact damped reduced camera system (module docstring identity),
    reduced chunk by chunk into a running R. The rescaled rows are formed
    per chunk, never all at once."""
    dtype = Rcc_aug.dtype
    ncols = Rcc_aug.shape[0]
    n9 = ncols - 1
    scale = torch.sqrt(_redamp_scale(fill_evals, lam)).to(dtype)  # (M, 3)
    lam_rows = torch.cat([
        _sqrt(lam) * torch.eye(n9, dtype=dtype, device=Rcc_aug.device),
        Rcc_aug.new_zeros((n9, 1))], dim=1)
    R = torch.linalg.qr(torch.cat([Rcc_aug, lam_rows]), mode="r")[1]
    step = max(1, max(ncols, chunk_rows) // 3)  # points per chunk
    for lo in range(0, QtRpc.shape[0], step):
        F = (QtRpc[lo:lo + step] * scale[lo:lo + step, :, None]).reshape(-1, ncols)
        R = torch.linalg.qr(torch.cat([R, F]), mode="r")[1]
    return R


def qrkit_pair_trial_sums(ctx: SchurContext, lam, pairs, n: int):
    """qrkit re-damp sums with pair tables: S_sum = sum_k B_k^T
    (lam/(eh+lam)) B_k and its rhs companion, through the weighted
    pair-gram tables. Deficient directions (eh = 0, w = 1) have zero B
    rows."""
    w = _redamp_scale(ctx.fill_evals, lam).T  # (3, M)
    sd = ctx.pairA.dtype
    return _pair_gram_tables(ctx, _ext(w.to(sd)), _ext((w * ctx.qr_cqT).to(sd)),
                             pairs, n, ctx.qr_S0cam.dtype)


def _camera_solve_qr_cached(ctx: SchurContext, lam, problem, n: int,
                            reduce: Reduce = LOCAL):
    """qrkit camera step from the cached lambda-free factors: with pair
    tables S(lam) = S0 + sum B^T (lam/(eh+lam)) B + lam I and the refined
    Cholesky solve; without them the row-QR re-damp of the dense cache and
    a triangular solve on one device, the gram re-damp on a shard (a row-QR
    does not split over ranks; a gram is a sum)."""
    dtype = ctx.U.dtype
    if ctx.qr_S0cam is not None:
        S_sum, b_sum = reduce.sum(*qrkit_pair_trial_sums(ctx, lam, problem.pairs, n))
        Scam = ctx.qr_S0cam + S_sum.to(dtype)
        Scam.diagonal().add_(lam)
        return _camera_solve_chol(Scam, ctx.qr_b0 + b_sum.reshape(-1).to(dtype))
    if reduce.sharded:
        return _qrkit_gram_camera_step(ctx, lam, n, reduce)
    n9 = 9 * n
    R = _redamp_qr(ctx.Rcc_aug, ctx.QtRpc, ctx.fill_evals, lam).to(dtype)
    return linalg.solve_upper_triangular(R[:n9, :n9], R[:n9, n9])


def _qrkit_gram_camera_step(ctx: SchurContext, lam, n: int,
                            reduce: Reduce = LOCAL, chunk_points: int = 8192):
    """The JAX package's TPU re-damp of the dense qrkit cache, in gram form
    (the sharded path's, and a reference for the parity tests):
        S_aug(lam) = Rcc_aug^T Rcc_aug + F^T F,
        F = diag(sqrt(lam/(eh+lam))) QtRpc,
    F^T F accumulated over point chunks (and ranks), then lam I and the
    refined Cholesky solve."""
    dtype = ctx.Rcc_aug.dtype
    n9 = 9 * n
    scale = torch.sqrt(_redamp_scale(ctx.fill_evals, lam)).to(dtype)
    G = ctx.Rcc_aug.new_zeros((n9 + 1, n9 + 1))
    for lo in range(0, ctx.QtRpc.shape[0], chunk_points):
        F = (ctx.QtRpc[lo:lo + chunk_points]
             * scale[lo:lo + chunk_points, :, None]).reshape(-1, n9 + 1)
        G += F.T @ F
    (G,) = reduce.sum(G)
    S_aug = ctx.Rcc_aug.T @ ctx.Rcc_aug + G
    Scam = S_aug[:n9, :n9].clone()
    Scam.diagonal().add_(lam)
    return _camera_solve_chol(Scam.to(ctx.U.dtype), S_aug[:n9, n9].to(ctx.U.dtype))


# -- spqr: the whole augmented matrix re-factored every trial -----------------


def camera_solve_qr(ctx: SchurContext, lam, problem, chunk: int = 1024,
                    reduce: Reduce = LOCAL):
    """spqr camera step, re-factored every trial in R-only CholeskyQR form:
    per chunk of points, the MGS QR of the augmented panels
    [Jp; sqrt(lam) I3] (Q1(lam)), the projected camera rows placed densely,
    and their gram accumulated (over chunks and ranks); then B^T B = U_aug -
    Rpc(lam)^T Rpc(lam) (projector identity), lam I, and the refined
    Cholesky solve."""
    dtype = ctx.U.dtype
    n = problem.n_cameras
    Js = ctx.Jp_stacked
    m = Js.shape[0]
    n9 = 9 * n
    cam_slot = _cam_per_slot(problem)
    eye3 = torch.eye(3, dtype=Js.dtype, device=Js.device)
    sl_eye = _sqrt(lam) * eye3
    G = Js.new_zeros((n9 + 1, n9 + 1), dtype=dtype)
    for lo in range(0, m, chunk):
        Jpc = Js[lo:lo + chunk]
        Q1, _ = linalg.mgs_qr3(
            torch.cat([Jpc, sl_eye.expand(Jpc.shape[0], 3, 3)], dim=1))
        B, c = _point_row_blocks(Q1, ctx.Jc_stacked[lo:lo + chunk],
                                 ctx.rhs_stacked[lo:lo + chunk])
        flat = _place_rows(B, c, cam_slot[lo:lo + chunk], n,
                           Js.dtype).reshape(-1, n9 + 1).to(dtype)
        G += flat.T @ flat
    (G,) = reduce.sum(G)
    # The corner energy is irrelevant: only S[:9N, :9N] and the rhs column
    # are used.
    S_aug = _aug_camera_gram(ctx.U, ctx.g_cams, 0.0, dtype) - G
    Scam = S_aug[:n9, :n9].clone()
    Scam.diagonal().add_(lam)
    return _camera_solve_chol(Scam, S_aug[:n9, n9].contiguous())


def _camera_solve_tsqr(ctx: SchurContext, lam, problem, Linv, mm_dtype=None,
                       chunk_points: int = TSQR_CHUNK_POINTS):
    """spqr camera step by Householder TSQR (the parity tests' reference
    for ``camera_solve_qr``): R (9N+1, 9N+1) of the point-projected camera
    rows, then the camera lambda rows [sqrt(lam) I_9N | 0], a final QR and
    the triangular solve.

    Per point p, the rows of the augmented system after the left block QR:
        B_p = (I - Q1 Q1^T) [A_cam | b],   Q1 = A_pt_aug L^-T,
    where A_pt_aug stacks the point's observation rows and sqrt(lam) I3
    (zero camera columns). Each chunk's rows are placed in dense 9N+1
    columns and reduced with the running R by ``torch.linalg.qr`` in the
    matmul dtype; the rhs column carries Q^T b through the reduction."""
    n, m = problem.n_cameras, problem.n_points
    dtype = mm_dtype or ctx.U.dtype
    lmax = problem.pt_obs_idx.shape[1]
    two_l = 2 * lmax
    n9 = 9 * n
    # Q1 in the accurate dtype (it encodes the point factor), then cast.
    Q1 = torch.cat([torch.einsum("mrj,mcj->mrc", ctx.Jp_stacked, Linv),
                    _sqrt(lam) * Linv.transpose(-1, -2)], dim=1).to(dtype)
    slot_cam = _cam_per_slot(problem).long().repeat_interleave(2, dim=1)
    j9 = torch.arange(9, device=Q1.device)
    R = Q1.new_zeros((n9 + 1, n9 + 1))
    for lo in range(0, m, chunk_points):
        hi = min(lo + chunk_points, m)
        p = hi - lo
        Ab = Q1.new_zeros((p, two_l + 3, n9 + 1))
        cols = 9 * slot_cam[lo:hi, :, None] + j9  # (P, 2Lmax, 9)
        Ab[:, :two_l, :n9].scatter_(2, cols, ctx.Jc_stacked[lo:hi].to(dtype))
        Ab[:, :two_l, n9] = ctx.rhs_stacked[lo:hi].to(dtype)
        Q1c = Q1[lo:hi]
        QtA = torch.einsum("prc,prj->pcj", Q1c, Ab)  # (P, 3, 9N+1)
        B = Ab - torch.einsum("prc,pcj->prj", Q1c, QtA)
        R = torch.linalg.qr(torch.cat([R, B.reshape(-1, n9 + 1)]), mode="r")[1]
    R = R.to(ctx.U.dtype)
    lam_rows = torch.cat([
        _sqrt(lam) * torch.eye(n9, dtype=R.dtype, device=R.device),
        R.new_zeros((n9, 1))], dim=1)
    R = torch.linalg.qr(torch.cat([R, lam_rows]), mode="r")[1]
    return linalg.solve_upper_triangular(R[:n9, :n9], R[:n9, n9])


def _back_substitute(ctx: SchurContext, lam, problem, dxc, Linv=None):
    """Point step from the camera step: (V + lam I) dx_p = g_p - sum_k
    W_k^T dx_c(cam_k), by the eigenbasis (Linv None) or by the point factor
    (V + lam I)^-1 = Linv^T Linv."""
    t = ctx.g_pts - point_coupling_sum(ctx.W, dxc, problem.obs.cam_idx, problem)
    if Linv is None:
        winv = 1.0 / (ctx.evals + lam)
        return torch.einsum("mij,mj->mi", ctx.evecs,
                            winv * torch.einsum("mji,mj->mi", ctx.evecs, t))
    y = torch.einsum("mij,mj->mi", Linv, t)
    return torch.einsum("mji,mj->mi", Linv, y)


def solve_damped(ctx: SchurContext, lam, problem, mode: str,
                 mm_dtype=None, reduce: Reduce = LOCAL):
    """Solve (J^T J + lam I) dx = -J^T f; returns (dx_pts (M,3), dx_cams (N,9)).

    ``lam`` is a Python float or a 0-dim float64 tensor (module
    docstring), already rounded to the context's dtype by the caller; ``mm_dtype`` and ``reduce`` must be the values
    ``build_context`` used. On a shard the reduced camera system (or
    spqr's and qrkit's camera gram) is totalled over the ranks and solved
    on every rank; the point step stays the rank's own."""
    check_mode(mode)
    point_factor, camera_solver = MODE_STRATEGY[mode]
    n = problem.n_cameras
    cam_idx = problem.obs.cam_idx
    dtype = ctx.U.dtype
    mm = mm_dtype or dtype
    Linv = None
    if point_factor != "eig":
        Linv = _point_factor_inv(ctx, lam, mode, dtype)

    if camera_solver == "chol":
        if ctx.pairA is not None:
            S_sum, b_sum = _pair_gram_cached(ctx, lam, problem.pairs, n, mm)
        elif point_factor == "eig":
            S_sum, b_sum = _schur_gram_chunked(
                ctx.WQ, 1.0 / (ctx.evals + lam), ctx.y0, cam_idx,
                problem.pt_obs_idx, n, mm)
        else:
            # Point-whitened coupling C_k = W_k L_p^-T and rhs L^-1 g_p.
            C = torch.einsum("kij,kcj->kic", ctx.W, Linv[problem.obs.pt_idx])
            y = torch.einsum("mij,mj->mi", Linv, ctx.g_pts)
            S_sum, b_sum = _schur_gram_chunked(C, None, y, cam_idx,
                                               problem.pt_obs_idx, n, mm)
        S_sum, b_sum = reduce.sum(S_sum, b_sum)
        dxc = _camera_solve_chol(*assemble_reduced(S_sum, b_sum, ctx, lam, n))
    elif camera_solver == "qr_cached":
        dxc = _camera_solve_qr_cached(ctx, lam, problem, n, reduce)
    else:
        dxc = camera_solve_qr(ctx, lam, problem, reduce=reduce)
    dxc = dxc.reshape(n, 9)
    return _back_substitute(ctx, lam, problem, dxc, Linv), dxc


def _reference_step(ctx: SchurContext, lam: float, problem, mode: str):
    """(dx_pts, dx_cams) of qrkit or spqr by its reference realization, for
    the parity tests: qrkit's dense cache re-damped in gram form
    (``_qrkit_gram_camera_step``), spqr by Householder TSQR
    (``_camera_solve_tsqr``)."""
    n = problem.n_cameras
    Linv = _point_factor_inv(ctx, lam, mode, ctx.U.dtype)
    if MODE_STRATEGY[mode][1] == "qr_cached":
        dxc = _qrkit_gram_camera_step(ctx, lam, n)
    else:
        dxc = _camera_solve_tsqr(ctx, lam, problem, Linv)
    dxc = dxc.reshape(n, 9)
    return _back_substitute(ctx, lam, problem, dxc, Linv), dxc


def refine_step(ctx: SchurContext, lam, problem, mode: str, dxp, dxc,
                mm_dtype=None):
    """One iterative-refinement pass on a damped step: the residual of
    (J^T J + lam I) dx = -J^T f in float64,
        r_c = g_c - (U + lam I) dx_c - sum_{k in cam} W_k dx_p(pt(k))
        r_p = g_p - (V + lam I) dx_p - sum_{k in pt} W_k^T dx_c(cam(k)),
    solved again by the same per-trial path with the rhs replaced, and
    added. Only the chol camera solver reads its rhs from g_cams/g_pts/y0;
    qrkit and spqr carry theirs in per-iteration caches, so they raise."""
    if MODE_STRATEGY[mode][1] != "chol":
        raise ValueError(
            f"refine_step supports the chol camera solver (cholesky, qrchol, "
            f"moreqr), not {mode!r}: its rhs lives in its lambda-free cache")
    obs = problem.obs
    f64 = torch.float64
    dtype = ctx.U.dtype
    n, m = problem.n_cameras, problem.n_points
    dxc_a, dxp_a = dxc.to(f64), dxp.to(f64)
    W = ctx.W.to(f64)
    cam, pt = obs.cam_idx.long(), obs.pt_idx.long()
    Wdxp = torch.einsum("kij,kj->ki", W, dxp_a[pt])  # (K, 9)
    coup_c = W.new_zeros((n, 9)).index_add_(0, cam, Wdxp)
    r_c = (ctx.g_cams.to(f64) - torch.einsum("nij,nj->ni", ctx.U.to(f64), dxc_a)
           - lam * dxc_a - coup_c)
    Wtdxc = torch.einsum("kij,ki->kj", W, dxc_a[cam])  # (K, 3)
    coup_p = W.new_zeros((m, 3)).index_add_(0, pt, Wtdxc)
    r_p = (ctx.g_pts.to(f64) - torch.einsum("mij,mj->mi", ctx.V.to(f64), dxp_a)
           - lam * dxp_a - coup_p)
    repl = dict(g_cams=r_c.to(dtype), g_pts=r_p.to(dtype))
    if ctx.y0 is not None:
        repl["y0"] = torch.einsum("mji,mj->mi", ctx.evecs.to(f64),
                                  r_p).to(ctx.y0.dtype)
    ddxp, ddxc = solve_damped(dataclasses.replace(ctx, **repl), lam, problem,
                              mode, mm_dtype=mm_dtype)
    return ((dxp_a + ddxp.to(f64)).to(dxp.dtype),
            (dxc_a + ddxc.to(f64)).to(dxc.dtype))


def gradient_dot(ctx: SchurContext, dxp, dxc, lam,
                 reduce: Reduce = LOCAL) -> torch.Tensor:
    """rhoScale = dx^T (lam dx + JtRes) (BacktrackLevMarqCholesky.h:300), as
    a float64 0-dim tensor. float32 steps are summed in float32 and the sums
    promoted (both terms are positive: no cancellation). On a shard the
    point terms are totalled over the ranks."""
    f64 = torch.float64

    def dsum(a, b):
        return (a * b).sum().to(f64)

    pt_dot, pt_norm2 = reduce.sum(dsum(dxp, ctx.g_pts.to(dxp.dtype)),
                                  dsum(dxp, dxp))
    jtres_dot = dsum(dxc, ctx.g_cams.to(dxc.dtype)) + pt_dot
    dx_norm2 = dsum(dxc, dxc) + pt_norm2
    return lam * dx_norm2 + jtres_dot

"""Batched closed-form 3x3 linear algebra (elementwise tensor ops), plus
the batched 3-column QR and the triangular solve of the QR solver modes.

M independent 3x3 point blocks are factored in closed form instead of by a
batched LAPACK call: pure elementwise arithmetic over (..., 3, 3) tensors.
"""

from __future__ import annotations

import math

import torch


def _stack33(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def cholesky3x3(A: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of SPD (..., 3, 3) blocks.

    ``clamp=True`` floors each pivot at max(1e-12, 8 eps) of the largest
    diagonal entry before the sqrt, so blocks whose small eigenvalues sit
    below the dtype's formation noise factor as a nearby SPD block instead
    of giving NaN."""
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    if clamp:
        eps_rel = max(1e-12, 8.0 * torch.finfo(A.dtype).eps)
        floor = eps_rel * torch.maximum(a11, torch.maximum(a22, a33))

        def piv(x):
            return torch.sqrt(torch.maximum(x, floor))
    else:
        piv = torch.sqrt
    l11 = piv(a11)
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = piv(a22 - l21 * l21)
    l32 = (a32 - l31 * l21) / l22
    l33 = piv(a33 - l31 * l31 - l32 * l32)
    zero = torch.zeros_like(l11)
    return _stack33([[l11, zero, zero], [l21, l22, zero], [l31, l32, l33]])


def inv_lower3x3(L: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of lower-triangular (..., 3, 3) blocks."""
    l11, l21, l31 = L[..., 0, 0], L[..., 1, 0], L[..., 2, 0]
    l22, l32, l33 = L[..., 1, 1], L[..., 2, 1], L[..., 2, 2]
    i11 = torch.reciprocal(l11)
    i22 = torch.reciprocal(l22)
    i33 = torch.reciprocal(l33)
    i21 = -l21 * i11 * i22
    i32 = -l32 * i22 * i33
    i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33
    zero = torch.zeros_like(l11)
    return _stack33([[i11, zero, zero], [i21, i22, zero], [i31, i32, i33]])


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _unit_x(like):
    e = torch.zeros_like(like)
    e[..., 0] = 1.0
    return e


def eigh3x3_sym(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 3, 3) blocks.

    Returns (evals (..., 3) ascending, evecs (..., 3, 3)) with
    A ~= evecs diag(evals) evecs^T. Trigonometric (Cardano) eigenvalues of
    the scale-normalised deviator, eigenvectors by the largest pairwise
    cross product of the rows of A - lam I, the better-isolated extreme
    eigenvalue first and the middle vector completing a right-handed frame
    (Eberly, "A Robust Eigensolver for 3x3 Symmetric Matrices").
    """
    dt = A.dtype
    eps = torch.finfo(dt).eps
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    s = torch.stack([a00.abs(), a01.abs(), a02.abs(),
                     a11.abs(), a12.abs(), a22.abs()]).amax(0)
    pos = s > 0
    sinv = torch.where(pos, torch.reciprocal(torch.where(pos, s, 1.0)), 1.0)
    a00, a01, a02 = a00 * sinv, a01 * sinv, a02 * sinv
    a11, a12, a22 = a11 * sinv, a12 * sinv, a22 * sinv

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(p2)
    psafe = torch.where(p > 0, p, 1.0)
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * psafe * psafe * psafe), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lam_mid = 3.0 * q - lam_hi - lam_lo

    def norm(v):
        return v / torch.sqrt((v * v).sum(-1, keepdim=True))

    def eigvec_of(lam):
        r0 = torch.stack([a00 - lam, a01, a02], -1)
        r1 = torch.stack([a01, a11 - lam, a12], -1)
        r2 = torch.stack([a02, a12, a22 - lam], -1)
        c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
        n01, n02, n12 = ((c * c).sum(-1) for c in (c01, c02, c12))
        best = torch.where(
            ((n01 >= n02) & (n01 >= n12))[..., None], c01,
            torch.where((n02 >= n12)[..., None], c02, c12),
        )
        nbest = torch.maximum(n01, torch.maximum(n02, n12))
        v = torch.where((nbest > eps * eps)[..., None], best, _unit_x(best))
        return norm(v)

    hi_first = (lam_hi - lam_mid) >= (lam_mid - lam_lo)
    lam_a = torch.where(hi_first, lam_hi, lam_lo)
    lam_b = torch.where(hi_first, lam_lo, lam_hi)
    v_a = eigvec_of(lam_a)
    v_b0 = eigvec_of(lam_b)
    v_b0 = v_b0 - (v_b0 * v_a).sum(-1, keepdim=True) * v_a
    nb = (v_b0 * v_b0).sum(-1, keepdim=True)
    e_y = torch.zeros_like(v_a)
    e_y[..., 1] = 1.0
    alt = _cross(v_a, _unit_x(v_a))
    alt2 = _cross(v_a, e_y)
    alt = torch.where((alt * alt).sum(-1, keepdim=True) > 0.1, alt, alt2)
    v_b = norm(torch.where(nb > eps * eps, v_b0, alt))
    v_m = _cross(v_a, v_b)

    hf = hi_first[..., None]
    v_hi = torch.where(hf, v_a, v_b)
    v_lo = torch.where(hf, v_b, v_a)
    evals = torch.stack([lam_lo, lam_mid, lam_hi], -1) * s[..., None]
    evecs = torch.stack([v_lo, v_m, v_hi], -1)
    return evals, evecs


def mgs_qr3(A: torch.Tensor, zero_deficient: bool = False):
    """Thin QR of (..., m, 3) blocks by modified Gram-Schmidt, unrolled.

    Returns (Q (..., m, 3), R (..., 3, 3) upper-triangular with a
    non-negative diagonal). Zero rows contribute nothing, so ragged blocks
    may be padded to a common m; the pivots are not floored (the augmented
    [J; sqrt(lam) I] stacks are full rank).

    ``zero_deficient=True`` is the rank guard for lambda-free stacks: a
    pivot at or below sqrt(eps) of the block's Frobenius norm gives an
    exactly zero Q column and R row, so Q's columns are orthonormal or zero
    (points seen once have rank <= 2)."""
    if zero_deficient:
        fro = torch.sqrt((A * A).sum(dim=(-2, -1)))
        tol = math.sqrt(torch.finfo(A.dtype).eps) * fro
        tiny = torch.finfo(A.dtype).tiny

        def pivot(v):
            n = torch.sqrt((v * v).sum(-1))
            ok = n > tol
            q = torch.where(ok[..., None], v / torch.clamp(n, min=tiny)[..., None],
                            torch.zeros_like(v))
            return torch.where(ok, n, torch.zeros_like(n)), q
    else:
        def pivot(v):
            n = torch.sqrt((v * v).sum(-1))
            return n, v / n[..., None]

    a1, a2, a3 = A[..., 0], A[..., 1], A[..., 2]
    r11, q1 = pivot(a1)
    r12 = (q1 * a2).sum(-1)
    v2 = a2 - r12[..., None] * q1
    r22, q2 = pivot(v2)
    r13 = (q1 * a3).sum(-1)
    v3 = a3 - r13[..., None] * q1
    r23 = (q2 * v3).sum(-1)
    v3 = v3 - r23[..., None] * q2
    r33, q3 = pivot(v3)
    zero = torch.zeros_like(r11)
    Q = torch.stack([q1, q2, q3], dim=-1)
    R = _stack33([[r11, r12, r13], [zero, r22, r23], [zero, zero, r33]])
    return Q, R


def solve_upper_triangular(R: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve R x = b for upper-triangular R (n, n) and b (n,)."""
    return torch.linalg.solve_triangular(R, b[:, None], upper=True)[:, 0]

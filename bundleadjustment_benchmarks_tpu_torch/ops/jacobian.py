"""Analytic BA Jacobian as dense per-observation blocks.

    Jc: (K, 2, 9)  d(robust residual_k)/d(camera params of cam_idx[k])
    Jp: (K, 2, 3)  d(robust residual_k)/d(point of pt_idx[k])

Camera column order: T(0:3), omega(3:6), f(6), k1(7), k2(8)
(reference BAFunctor.h:126-261; left-multiplied incremental rotation).
The f64 Jacobian uses the reference's robust outer factor
(robust.robust_outer_derivative), as the JAX package does; the df32 planar
chain uses its stable closed form (robust.outer_coeffs), as the JAX package's
df32 chain does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import projection, robust, rodrigues


class JacobianBlocks(NamedTuple):
    Jc: torch.Tensor  # (K, 2, 9)
    Jp: torch.Tensor  # (K, 2, 3)
    f: torch.Tensor  # (K, 2) robustified residuals


def residuals_and_jacobian(state, obs, tau2, compute_dtype=None) -> JacobianBlocks:
    """Robustified residuals and Jacobian blocks on a BAState.

    ``compute_dtype``: R X + T runs in the state dtype, the rest of the
    chain in compute_dtype (mixed precision)."""
    ci = obs.cam_idx
    R, T = state.R[ci], state.T[ci]
    focal, k1, k2 = state.K[ci, 0, 0], state.k1[ci], state.k2[ci]
    X = state.points[obs.pt_idx]
    XX = projection.ordered_bmm(R, X[:, :, None])[:, :, 0] + T
    meas = obs.measurements
    if compute_dtype is not None and XX.dtype != compute_dtype:
        XX, R, T, focal, k1, k2, meas = (
            t.to(compute_dtype) for t in (XX, R, T, focal, k1, k2, meas)
        )
    RX = XX - T
    z = XX[:, 2]
    xu = XX[:, :2] / z[:, None]
    x, y = xu[:, 0], xu[:, 1]
    r2 = x * x + y * y
    kr = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = kr[:, None] * xu
    r = focal[:, None] * xd - meas

    inv_z = torch.reciprocal(z)
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(inv_z)
    dxu_dXX = torch.stack(
        [
            torch.stack([inv_z, zeros, -XX[:, 0] * inv_z2], -1),
            torch.stack([zeros, inv_z, -XX[:, 1] * inv_z2], -1),
        ],
        -2,
    )  # (K, 2, 3)
    dkr = 2.0 * k1 + 4.0 * k2 * r2
    d01 = x * y * dkr
    dxd_dxu = torch.stack(
        [
            torch.stack([kr + x * x * dkr, d01], -1),
            torch.stack([d01, kr + y * y * dkr], -1),
        ],
        -2,
    )
    bmm = projection.ordered_bmm
    dp_dXX = bmm(focal[:, None, None] * dxd_dxu, dxu_dXX)  # (K, 2, 3)
    dp_dw = bmm(dp_dXX, -rodrigues.cross_product_matrix(RX))
    r4 = r2 * r2
    d_dk = focal[:, None, None] * torch.stack(
        [torch.stack([x * r2, x * r4], -1), torch.stack([y * r2, y * r4], -1)],
        -2,
    )
    Jc = torch.cat([dp_dXX, dp_dw, xd[..., None], d_dk], dim=-1)  # (K, 2, 9)
    Jp = bmm(dp_dXX, R)

    outer = robust.robust_outer_derivative(tau2, r)  # (K, 2, 2)
    return JacobianBlocks(Jc=bmm(outer, Jc), Jp=bmm(outer, Jp),
                          f=r * robust.robust_scale(tau2, r)[:, None])


#: Row layout of the planar chain: f(2), Jc row0(9), Jc row1(9), Jp row0(3),
#: Jp row1(3).
PLANAR_CHAIN_ROWS = 26


def planar_blocks_chain(camg, ptsg, m0, m1, tau2):
    """Robustified residual + Jacobian chain on planar float32 rows.

    ``camg``/``ptsg`` are indexables of 27/6 like-shaped rows, ``m0``/``m1``
    the measurement rows, ``tau2`` a float32 0-dim tensor. Returns the 26
    rows [f0, f1, jc0_0..jc0_8, jc1_0..jc1_8, jp0_0..jp0_2, jp1_0..jp1_2].
    This is the plain version of the CUDA blocks kernel
    (csrc/chain_math.cuh repeats it op for op).
    """
    RX, XX = projection.planar_transform_df(camg, ptsg)
    r0, r1, kr, xu0, xu1, r2, invz = projection.planar_residual_comps(
        camg, XX, m0, m1
    )
    focal, k1, k2 = camg[24], camg[25], camg[26]

    dkr = 2.0 * k1 + 4.0 * k2 * r2
    p00 = focal * (kr + xu0 * xu0 * dkr)
    p01 = focal * (xu0 * xu1 * dkr)
    p11 = focal * (kr + xu1 * xu1 * dkr)

    dp = [
        [p00 * invz, p01 * invz, -(p00 * xu0 + p01 * xu1) * invz],
        [p01 * invz, p11 * invz, -(p01 * xu0 + p11 * xu1) * invz],
    ]
    # mJ = -[R X]_x (BAFunctor.h:126-142).
    a, b, c = RX[0].hi, RX[1].hi, RX[2].hi
    zer = torch.zeros_like(a)
    mJ = [[zer, c, -b], [-c, zer, a], [b, -a, zer]]

    def dot3(row, col):
        return (row[0] * col(0) + row[1] * col(1)) + row[2] * col(2)

    dpw = [[dot3(dp[r], lambda s: mJ[s][ci]) for ci in range(3)]
           for r in range(2)]
    jp = [[dot3(dp[r], lambda s: camg[3 * s + ci]) for ci in range(3)]
          for r in range(2)]

    xd0, xd1 = kr * xu0, kr * xu1
    r4 = r2 * r2
    jc = [
        dp[0] + dpw[0] + [xd0, focal * xu0 * r2, focal * xu0 * r4],
        dp[1] + dpw[1] + [xd1, focal * xu1 * r2, focal * xu1 * r4],
    ]

    rn2 = r0 * r0 + r1 * r1
    cr, cd = robust.outer_coeffs(rn2, tau2)
    o00 = cr * r0 * r0 + cd
    o01 = cr * r0 * r1
    o11 = cr * r1 * r1 + cd

    def rob(rows):
        return [
            [o00 * rows[0][i] + o01 * rows[1][i] for i in range(len(rows[0]))],
            [o01 * rows[0][i] + o11 * rows[1][i] for i in range(len(rows[0]))],
        ]

    jc = rob(jc)
    jp = rob(jp)
    return [r0 * cd, r1 * cd] + jc[0] + jc[1] + jp[0] + jp[1]


def blocks_from_planar_rows(rows: torch.Tensor) -> JacobianBlocks:
    """(26, K) planar rows -> JacobianBlocks (one transpose each)."""
    return JacobianBlocks(
        Jc=rows[2:20].T.reshape(-1, 2, 9),
        Jp=rows[20:26].T.reshape(-1, 2, 3),
        f=rows[0:2].T,
    )


def planar_rows_from_blocks(blocks: JacobianBlocks) -> torch.Tensor:
    """JacobianBlocks -> (26, K) planar rows, the inverse of
    blocks_from_planar_rows."""
    k = blocks.f.shape[0]
    return torch.cat([blocks.f.T, blocks.Jc.reshape(k, 18).T,
                      blocks.Jp.reshape(k, 6).T])


def residuals_and_jacobian_fast(fast, obs, tau2) -> JacobianBlocks:
    """df32 drive: the planar chain on gathered rows (plain torch ops)."""
    return blocks_from_planar_rows(planar_chain_rows(fast, obs, tau2))


def planar_chain_rows(fast, obs, tau2) -> torch.Tensor:
    """The (26, K) float32 rows of planar_blocks_chain for a FastBAState."""
    camg, ptsg = projection.planar_gather(fast, obs)
    m = obs.measurements_pl
    return torch.stack(planar_blocks_chain(
        camg, ptsg, m[0], m[1], projection.tau2_f32(tau2, m.device)
    ))

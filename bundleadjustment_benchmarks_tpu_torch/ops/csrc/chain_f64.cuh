// Per-observation math of the float64 BA chain, for one observation.
//
// Straight-line C++ of the plain PyTorch functions it must agree with
// (bundleadjustment_benchmarks_tpu_torch/ops): jacobian.residuals_and_jacobian
// with robust.robust_outer_derivative for the 2x2 outer factor and
// robust.robust_scale for the residual, and projection.energy for the trial
// energy. Every expression keeps the operand order of its Python
// counterpart, so each op rounds as one PyTorch op does on CUDA; the small
// per-observation products (R X, the 2x2 by 2x3 chain rule, [R X]_x, R and
// the outer factor) are summed in index order, as projection.ordered_bmm
// sums them. The chain's few divisions by the threshold tau2 that PyTorch
// takes by a Python scalar (robust.psi inside robust_scale) are a product
// with its reciprocal on CUDA; the ones by a 0-dim tensor
// (robust_outer_derivative) are true divisions. Both are kept.
//
// Rounding is pinned by the build, as for the df32 chain: --fmad=false,
// -prec-div=true, -prec-sqrt=true.
#pragma once

#include <math.h>

namespace chain64 {

constexpr int kCam = 15;   // R (9), T (3), K[0, 0], k1, k2
constexpr int kRows = 26;  // f0 f1, Jc0(9) Jc1(9), Jp0(3) Jp1(3)
// robust.EPS_PSI_RESIDUAL
constexpr double kEps = 1e-15;

// torch.maximum(a, b) and torch.clamp(b, min=a) for a that is not NaN: a
// NaN b stays NaN.
__device__ __forceinline__ double tmax(double a, double b) {
  return b != b ? b : (b > a ? b : a);
}

// The raw residual of projection.residuals_raw and what the Jacobian reuses.
struct Residual {
  double XX[3];  // R X + T
  double x, y;   // the projected point, XX[:2] / XX[2]
  double r2, kr;
  double r0, r1;
};

__device__ __forceinline__ void residual(const double cam[kCam],
                                         const double X[3], double m0,
                                         double m1, Residual &q) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q.XX[i] = (cam[3 * i] * X[0] + cam[3 * i + 1] * X[1] +
               cam[3 * i + 2] * X[2]) + cam[9 + i];
  q.x = q.XX[0] / q.XX[2];
  q.y = q.XX[1] / q.XX[2];
  q.r2 = q.x * q.x + q.y * q.y;
  q.kr = 1.0 + cam[13] * q.r2 + cam[14] * q.r2 * q.r2;
  q.r0 = cam[12] * (q.kr * q.x) - m0;
  q.r1 = cam[12] * (q.kr * q.y) - m1;
}

// robust.robust_scale: sqrt(psi(|r|^2)) / max(eps, |r|), psi's r2 / tau2
// as r2 * (1 / tau2).
__device__ __forceinline__ double robust_scale(double rr, double tau2,
                                               double inv_tau2) {
  const double psi =
      rr < tau2 ? rr * (2.0 - rr * inv_tau2) * 0.25 : tau2 * 0.25;
  return sqrt(psi) / tmax(kEps, sqrt(rr));
}

// f0^2 + f1^2 of the robustified residual (projection.energy).
__device__ __forceinline__ double energy(const double cam[kCam],
                                         const double X[3], double m0,
                                         double m1, double tau2,
                                         double inv_tau2) {
  Residual q;
  residual(cam, X, m0, m1, q);
  const double s = robust_scale(q.r0 * q.r0 + q.r1 * q.r1, tau2, inv_tau2);
  const double f0 = q.r0 * s, f1 = q.r1 * s;
  return f0 * f0 + f1 * f1;
}

// The 26 rows of one observation, row r at out[r * stride]: the
// robustified residual, outer @ Jc and outer @ Jp
// (jacobian.residuals_and_jacobian). Returns f0^2 + f1^2.
__device__ __forceinline__ double blocks(const double cam[kCam],
                                         const double X[3], double m0,
                                         double m1, double tau2,
                                         double inv_tau2, double *out,
                                         size_t stride) {
  Residual q;
  residual(cam, X, m0, m1, q);
  const double focal = cam[12], k1 = cam[13], k2 = cam[14];

  // robust.robust_outer_derivative, tau2 a 0-dim tensor.
  const double rr = q.r0 * q.r0 + q.r1 * q.r1;
  const double W = tmax(0.0, 1.0 - rr / tau2);
  const double psi = rr < tau2 ? rr * (2.0 - rr / tau2) / 4.0 : tau2 / 4.0;
  const double sqrt_psi = sqrt(psi);
  const double rsqrt_psi = 1.0 / tmax(kEps, sqrt_psi);
  const double rcp_r2 = 1.0 / tmax(kEps, rr);
  const double rnorm = sqrt(rr);
  const double rnorm_r = 1.0 / tmax(kEps, rnorm);
  const double t00 = q.r0 * q.r0 * rnorm_r, t01 = q.r0 * q.r1 * rnorm_r,
               t11 = q.r1 * q.r1 * rnorm_r;
  const double ca = W / 2.0 * rsqrt_psi, cb = sqrt_psi * rcp_r2;
  const double o00 = ca * t00 + cb * (rnorm * 1.0 - t00);
  const double o01 = ca * t01 + cb * (rnorm * 0.0 - t01);
  const double o11 = ca * t11 + cb * (rnorm * 1.0 - t11);

  const double s = robust_scale(rr, tau2, inv_tau2);
  const double f0 = q.r0 * s, f1 = q.r1 * s;
  out[0] = f0;
  out[stride] = f1;

  // d(xu)/d(XX), d(xd)/d(xu) and their product dp = (focal dxd_dxu) dxu_dXX.
  const double inv_z = 1.0 / q.XX[2];
  const double inv_z2 = inv_z * inv_z;
  const double D[2][3] = {{inv_z, 0.0, -q.XX[0] * inv_z2},
                          {0.0, inv_z, -q.XX[1] * inv_z2}};
  const double dkr = 2.0 * k1 + 4.0 * k2 * q.r2;
  const double d01 = q.x * q.y * dkr;
  const double F[2][2] = {{focal * (q.kr + q.x * q.x * dkr), focal * d01},
                          {focal * d01, focal * (q.kr + q.y * q.y * dkr)}};
  double dp[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dp[i][j] = F[i][0] * D[0][j] + F[i][1] * D[1][j];

  // -[R X]_x with R X = XX - T (rodrigues.cross_product_matrix, negated).
  const double a = q.XX[0] - cam[9], b = q.XX[1] - cam[10],
               c = q.XX[2] - cam[11];
  const double mJ[3][3] = {{-0.0, c, -b}, {-c, -0.0, a}, {b, -a, -0.0}};
  const double r4 = q.r2 * q.r2;
  const double xu[2] = {q.x, q.y};

  // Jc = [dp, dp mJ, xd, focal xu r2, focal xu r4], then outer @ Jc.
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    double jc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (j < 3)
        jc[i] = dp[i][j];
      else if (j < 6)
        jc[i] = dp[i][0] * mJ[0][j - 3] + dp[i][1] * mJ[1][j - 3] +
                dp[i][2] * mJ[2][j - 3];
      else if (j == 6)
        jc[i] = q.kr * xu[i];
      else if (j == 7)
        jc[i] = focal * (xu[i] * q.r2);
      else
        jc[i] = focal * (xu[i] * r4);
    }
    out[(2 + j) * stride] = o00 * jc[0] + o01 * jc[1];
    out[(11 + j) * stride] = o01 * jc[0] + o11 * jc[1];
  }
  // Jp = dp R, then outer @ Jp.
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    double jp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      jp[i] = dp[i][0] * cam[j] + dp[i][1] * cam[3 + j] + dp[i][2] * cam[6 + j];
    out[(20 + j) * stride] = o00 * jp[0] + o01 * jp[1];
    out[(23 + j) * stride] = o01 * jp[0] + o11 * jp[1];
  }
  return f0 * f0 + f1 * f1;
}

}  // namespace chain64

// Per-observation math of the df32 BA chain, for one observation.
//
// Straight-line C++ of the plain PyTorch functions it must agree with bit
// for bit (bundleadjustment_benchmarks_tpu_torch/ops):
//   projection.planar_transform_df -> projection.planar_residual_comps ->
//   jacobian.planar_blocks_chain / projection.planar_energy_df,
// with robust.outer_coeffs for the robust factor. Every expression keeps the
// operand order of its Python counterpart (C++ and Python group + - * /
// alike), so each op rounds exactly as one PyTorch elementwise op does.
//
// Rounding is pinned by the build: --fmad=false (no a*b+c contraction, which
// would silently break the two-float error-free transformations),
// -prec-div=true and -prec-sqrt=true (IEEE division and square root), never
// --use_fast_math. two_prod uses one explicit fmaf: it is exact and gives the
// same error term as Dekker's split.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define CHAIN_HD __host__ __device__ __forceinline__
#else
#define CHAIN_HD inline
#endif

namespace chain {

constexpr int kCamPack = 27;   // 9 R.hi, 9 R.lo, 3 T.hi, 3 T.lo, focal, k1, k2
constexpr int kBlockRows = 26; // f0 f1, Jc0(9) Jc1(9), Jp0(3) Jp1(3)

struct DF {
  float hi, lo;
};

// ---- error-free transformations (ops/twofloat.py) ----

CHAIN_HD void two_sum(float a, float b, float &s, float &e) {
  s = a + b;
  float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

CHAIN_HD void quick_two_sum(float a, float b, float &s, float &e) {
  s = a + b;
  e = b - (s - a);
}

CHAIN_HD void two_prod(float a, float b, float &p, float &e) {
  p = a * b;
  e = fmaf(a, b, -p);  // exact error of the rounded product
}

CHAIN_HD DF df_add(DF x, DF y) {
  float s, e;
  two_sum(x.hi, y.hi, s, e);
  e = e + (x.lo + y.lo);
  DF r;
  quick_two_sum(s, e, r.hi, r.lo);
  return r;
}

CHAIN_HD DF df_mul(DF x, DF y) {
  float p, e;
  two_prod(x.hi, y.hi, p, e);
  e = e + (x.hi * y.lo + x.lo * y.hi);
  DF r;
  quick_two_sum(p, e, r.hi, r.lo);
  return r;
}

CHAIN_HD DF prod_ff(float a, float b) {
  DF r;
  two_prod(a, b, r.hi, r.lo);
  return r;
}

// torch.maximum / torch.clamp(min=) semantics: NaN propagates.
CHAIN_HD float maxp(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// ---- world -> camera transform in DF (projection.planar_transform_df) ----

CHAIN_HD void transform_df(const float *cam, const float xh[3],
                           const float xl[3], DF RX[3], DF XX[3]) {
  for (int i = 0; i < 3; ++i) {
    DF acc = df_mul(DF{cam[3 * i + 0], cam[9 + 3 * i + 0]}, DF{xh[0], xl[0]});
    acc = df_add(acc, df_mul(DF{cam[3 * i + 1], cam[9 + 3 * i + 1]},
                             DF{xh[1], xl[1]}));
    acc = df_add(acc, df_mul(DF{cam[3 * i + 2], cam[9 + 3 * i + 2]},
                             DF{xh[2], xl[2]}));
    RX[i] = acc;
    XX[i] = df_add(acc, DF{cam[18 + i], cam[21 + i]});
  }
}

// ---- raw residual chain (projection.planar_residual_comps) ----

struct Residual {
  float r0, r1, kr, xu0, xu1, r2, invz;
};

CHAIN_HD Residual residual_comps(const float *cam, const DF XX[3], float m0,
                                 float m1) {
  Residual o;
  o.invz = 1.0f / XX[2].hi;
  o.xu0 = XX[0].hi * o.invz;
  o.xu1 = XX[1].hi * o.invz;
  o.r2 = o.xu0 * o.xu0 + o.xu1 * o.xu1;
  const float k1 = cam[25], k2 = cam[26], focal = cam[24];
  o.kr = 1.0f + k1 * o.r2 + k2 * o.r2 * o.r2;
  o.r0 = focal * o.kr * o.xu0 - m0;
  o.r1 = focal * o.kr * o.xu1 - m1;
  return o;
}

// ---- stable robust outer factor (robust.outer_coeffs) ----

CHAIN_HD void outer_coeffs(float rn2, float tau2, float &cr, float &cd) {
  const float u = rn2 / tau2;
  const bool inl = rn2 < tau2;
  const float tau = sqrtf(tau2);
  const float som = sqrtf(maxp(2.0f - u, 0.0f));  // inlier branch only
  const float rn2_out = maxp(rn2, tau2);
  const float rnorm_out = sqrtf(rn2_out);
  cr = inl ? -(1.0f / (2.0f * tau2 * maxp(som, 1.0f)))
           : (-tau) / (2.0f * rn2_out * rnorm_out);
  cd = inl ? som / 2.0f : tau / (2.0f * rnorm_out);
}

// ---- robustified energy of one observation (projection.planar_energy_df) ----

CHAIN_HD DF energy_df(const float *cam, const DF XX[3], float m0, float m1,
                      float tau2) {
  const Residual q = residual_comps(cam, XX, m0, m1);
  const float rn2 = q.r0 * q.r0 + q.r1 * q.r1;
  float cr, s;
  outer_coeffs(rn2, tau2, cr, s);
  return df_add(prod_ff(q.r0 * s, q.r0 * s), prod_ff(q.r1 * s, q.r1 * s));
}

// ---- residuals + Jacobian rows (jacobian.planar_blocks_chain) ----

CHAIN_HD void blocks_chain(const float *cam, const float xh[3],
                           const float xl[3], float m0, float m1, float tau2,
                           float out[kBlockRows]) {
  DF RX[3], XX[3];
  transform_df(cam, xh, xl, RX, XX);
  const Residual q = residual_comps(cam, XX, m0, m1);
  const float r0 = q.r0, r1 = q.r1, kr = q.kr, xu0 = q.xu0, xu1 = q.xu1,
              r2 = q.r2, invz = q.invz;
  const float focal = cam[24], k1 = cam[25], k2 = cam[26];

  const float dkr = 2.0f * k1 + 4.0f * k2 * r2;
  const float p00 = focal * (kr + xu0 * xu0 * dkr);
  const float p01 = focal * (xu0 * xu1 * dkr);
  const float p11 = focal * (kr + xu1 * xu1 * dkr);

  float dp[2][3];
  dp[0][0] = p00 * invz;
  dp[0][1] = p01 * invz;
  dp[0][2] = -(p00 * xu0 + p01 * xu1) * invz;
  dp[1][0] = p01 * invz;
  dp[1][1] = p11 * invz;
  dp[1][2] = -(p01 * xu0 + p11 * xu1) * invz;

  // mJ = -[R X]_x; the zero entries are multiplied like the plain version's
  // zero rows (no folding: IEEE x * 0 is not a constant).
  const float a = RX[0].hi, b = RX[1].hi, c = RX[2].hi, zer = 0.0f;
  const float mJ[3][3] = {{zer, c, -b}, {-c, zer, a}, {b, -a, zer}};

  float jc[2][9], jp[2][3];
  for (int r = 0; r < 2; ++r) {
    for (int ci = 0; ci < 3; ++ci) {
      jc[r][ci] = dp[r][ci];
      jc[r][3 + ci] = (dp[r][0] * mJ[0][ci] + dp[r][1] * mJ[1][ci]) +
                      dp[r][2] * mJ[2][ci];
      jp[r][ci] = (dp[r][0] * cam[ci] + dp[r][1] * cam[3 + ci]) +
                  dp[r][2] * cam[6 + ci];
    }
  }
  const float r4 = r2 * r2;
  jc[0][6] = kr * xu0;
  jc[0][7] = focal * xu0 * r2;
  jc[0][8] = focal * xu0 * r4;
  jc[1][6] = kr * xu1;
  jc[1][7] = focal * xu1 * r2;
  jc[1][8] = focal * xu1 * r4;

  const float rn2 = r0 * r0 + r1 * r1;
  float cr, cd;
  outer_coeffs(rn2, tau2, cr, cd);
  const float o00 = cr * r0 * r0 + cd;
  const float o01 = cr * r0 * r1;
  const float o11 = cr * r1 * r1 + cd;

  out[0] = r0 * cd;
  out[1] = r1 * cd;
  for (int i = 0; i < 9; ++i) {
    out[2 + i] = o00 * jc[0][i] + o01 * jc[1][i];
    out[11 + i] = o01 * jc[0][i] + o11 * jc[1][i];
  }
  for (int i = 0; i < 3; ++i) {
    out[20 + i] = o00 * jp[0][i] + o01 * jp[1][i];
    out[23 + i] = o01 * jp[0][i] + o11 * jp[1][i];
  }
}

}  // namespace chain

"""The port's LM driver against the JAX package's jit drive on the CPU."""

import jax.numpy as jnp
import pytest

from bundleadjustment_benchmarks_tpu.ops import projection as jproj
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.solvers import lm


def _pair(seed, **kw):
    jp = make_synthetic_problem(dtype=jnp.float64, seed=seed, **kw)
    return jp, convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_f64_matches_jax(seed):
    """Same iterations, function evaluations and status; final energy to
    1e-9 relative (measured ~1e-12: both solve the float64 system, in other
    summation orders). tau = 2 px, as the synthetic generator advises for
    runs that compare endpoints: at its default 0.5 px which truncation
    plateau LM lands on depends on rounding noise."""
    jp, tp = _pair(seed, n_cameras=6, n_points=40, obs_per_point=4,
                   inlier_threshold=2.0)
    res_j = jlm.minimize(jp, mode="cholesky",
                         config=jlm.LMConfig(drive="jit", max_iter=6))
    res_t = lm.minimize(tp, mode="cholesky", config=lm.LMConfig(max_iter=6),
                        device="cpu")
    assert (res_t.iterations, res_t.fun_evals, int(res_t.status)) == (
        res_j.iterations, res_j.fun_evals, int(res_j.status))
    gap = abs(res_t.energy - res_j.energy) / res_j.energy
    print(f"gap LM f64 seed {seed}: iterations {res_t.iterations}, "
          f"fun_evals {res_t.fun_evals}, energy {gap:.3g}")
    assert gap <= 1e-9, gap
    assert res_t.lam == pytest.approx(res_j.lam, rel=1e-6)


@pytest.mark.parametrize("tau", [0.5, 2.0])
def test_lm_df32_converges(tau):
    """The df32 drive on the plain chain, as the reference package's own
    kernel test asks of its Pallas drive: energy below half the start. The
    endpoints of the two packages are not compared: their df32 rows differ
    by ~1e-8 of scale (XLA on the CPU contracts multiply-adds, the port
    rounds each operation), and at tau = 0.5 px that noise picks another
    truncation plateau within a few iterations."""
    jp, tp = _pair(3, n_cameras=5, n_points=37, obs_per_point=5,
                   inlier_threshold=tau)
    e0 = float(jproj.energy(jp.state, jp.obs, jp.tau2))
    cfg_j = jlm.LMConfig(drive="jit", max_iter=8, matmul_dtype="float32",
                         geometry="df32")
    res_j = jlm.minimize(jp, mode="cholesky", config=cfg_j)
    res_t = lm.minimize(tp, mode="cholesky", device="cpu", config=lm.LMConfig(
        max_iter=8, matmul_dtype="float32", geometry="df32"))
    gap = abs(res_t.energy - res_j.energy) / res_j.energy
    print(f"gap LM df32 tau {tau}: port {res_t.energy:.6g}, JAX {res_j.energy:.6g}, "
          f"start {e0:.6g}, relative gap {gap:.3g}")
    assert res_t.energy < 0.5 * e0, (
        f"port {res_t.energy} vs start {e0}; JAX reached {res_j.energy} "
        f"(relative gap {gap:.3g})")
    assert res_t.state.points.shape == (tp.n_points, 3)


def test_lm_limits_and_bookkeeping():
    """max_iter = 0 does no work; a run stopped by max_iter counts the
    iteration that found the limit, as the reference does."""
    jp, tp = _pair(0, n_cameras=4, n_points=12, obs_per_point=3)
    res = lm.minimize(tp, config=lm.LMConfig(max_iter=0), device="cpu")
    assert (res.status, res.iterations, res.fun_evals) == (
        lm.LMStatus.MaxItersReached, 1, 0)
    res = lm.minimize(tp, config=lm.LMConfig(max_iter=2), device="cpu")
    assert res.status == lm.LMStatus.MaxItersReached and res.iterations == 3
    res = lm.minimize(tp, config=lm.LMConfig(max_fun_ev=1), device="cpu")
    assert res.status == lm.LMStatus.TooManyFunctionEvaluation
    assert lm.STATUS_STRINGS[res.status] == "Too Many Function Evaluations"

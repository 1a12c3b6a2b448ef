"""The port's LM driver against the JAX package's jit drive on the CPU."""

import jax.numpy as jnp
import pytest

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.ops import projection as jproj
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.solvers import lm


def _pair(seed, **kw):
    jp = make_synthetic_problem(dtype=jnp.float64, seed=seed, **kw)
    return jp, convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")


MODES = ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_lm_f64_matches_jax(seed, mode):
    """Same iterations, function evaluations and status; final energy to
    1e-9 relative (measured ~1e-12: both solve the float64 system, in other
    summation orders). tau = 2 px, as the synthetic generator advises for
    runs that compare endpoints: at its default 0.5 px which truncation
    plateau LM lands on depends on rounding noise. Every mode flatlines
    within the 10 iterations allowed (qrkit, moreqr and spqr start from the
    larger More lambda and take 6-8).

    lambda is compared after the run and after the run stopped one
    iteration earlier. The last step's lambda update divides that step's
    energy decrease by its predicted decrease (rho); it is compared when the
    decrease is resolved, i.e. at least 100x the two packages' energy
    disagreement at the step's two ends, so that rho is known to 1%. Where
    it is not, the update follows rounding noise: seed 0's last step
    decreases the energy by 9.9e-15 (5.3e-15 in the port), and the two
    packages' energies at its two ends differ by 4.6e-15 in all, rounding
    of the gauge directions that only lambda damps. rho is then 1.20 in JAX
    and 0.64 in the port, and lambda's multiplier
    max(1/3, 1 - (2 rho - 1)^3) agrees only while both fall above
    rho = 0.937, where it is 1/3."""
    jp, tp = _pair(seed, n_cameras=6, n_points=40, obs_per_point=4,
                   inlier_threshold=2.0)

    def run(max_iter):
        res_j = jlm.minimize(jp, mode=mode,
                             config=jlm.LMConfig(drive="jit", max_iter=max_iter))
        res_t = lm.minimize(tp, mode=mode,
                            config=lm.LMConfig(drive="host", max_iter=max_iter),
                            device="cpu")
        return res_j, res_t

    res_j, res_t = run(10)
    assert res_j.status == jlm.LMStatus.Success
    assert (res_t.iterations, res_t.fun_evals, int(res_t.status)) == (
        res_j.iterations, res_j.fun_evals, int(res_j.status))
    gap = abs(res_t.energy - res_j.energy) / res_j.energy
    print(f"gap LM f64 {mode} seed {seed}: iterations {res_t.iterations}, "
          f"fun_evals {res_t.fun_evals}, energy {gap:.3g}")
    assert gap <= 1e-9, gap
    prev_j, prev_t = run(res_j.iterations - 1)
    assert (prev_t.iterations, prev_t.fun_evals) == (prev_j.iterations,
                                                     prev_j.fun_evals)
    assert prev_t.lam == pytest.approx(prev_j.lam, rel=1e-6)
    decrease = prev_j.energy - res_j.energy
    disagreement = (abs(prev_t.energy - prev_j.energy)
                    + abs(res_t.energy - res_j.energy))
    print(f"last step {mode} seed {seed}: decrease {decrease:.3g} (port "
          f"{prev_t.energy - res_t.energy:.3g}), disagreement "
          f"{disagreement:.3g}, lambda {prev_t.lam:.17g} -> {res_t.lam:.17g} "
          f"(JAX {prev_j.lam:.17g} -> {res_j.lam:.17g})")
    if decrease >= 100.0 * disagreement:
        assert res_t.lam == pytest.approx(res_j.lam, rel=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tau", [0.5, 2.0])
def test_lm_df32_converges(tau, mode):
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
    res_j = jlm.minimize(jp, mode=mode, config=cfg_j)
    res_t = lm.minimize(tp, mode=mode, device="cpu", config=lm.LMConfig(drive="host",
        max_iter=8, matmul_dtype="float32", geometry="df32"))
    gap = abs(res_t.energy - res_j.energy) / res_j.energy
    print(f"gap LM df32 {mode} tau {tau}: port {res_t.energy:.6g}, JAX {res_j.energy:.6g}, "
          f"start {e0:.6g}, relative gap {gap:.3g}")
    assert res_t.energy < 0.5 * e0, (
        f"port {res_t.energy} vs start {e0}; JAX reached {res_j.energy} "
        f"(relative gap {gap:.3g})")
    assert res_t.state.points.shape == (tp.n_points, 3)


def test_lm_limits_and_bookkeeping():
    """max_iter = 0 does no work; a run stopped by max_iter counts the
    iteration that found the limit, as the reference does."""
    jp, tp = _pair(0, n_cameras=4, n_points=12, obs_per_point=3)
    res = lm.minimize(tp, config=lm.LMConfig(drive="host", max_iter=0),
                      device="cpu")
    assert (res.status, res.iterations, res.fun_evals) == (
        lm.LMStatus.MaxItersReached, 1, 0)
    res = lm.minimize(tp, config=lm.LMConfig(drive="host", max_iter=2),
                      device="cpu")
    assert res.status == lm.LMStatus.MaxItersReached and res.iterations == 3
    res = lm.minimize(tp, config=lm.LMConfig(drive="host", max_fun_ev=1),
                      device="cpu")
    assert res.status == lm.LMStatus.TooManyFunctionEvaluation
    assert lm.STATUS_STRINGS[res.status] == "Too Many Function Evaluations"

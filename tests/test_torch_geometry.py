"""The port's geometry against the JAX package on the CPU.

Same inputs on both sides: a seeded synthetic problem built by the JAX
package and carried across with ``convert``. f64 geometry, the df32 planar
chain (against both the JAX XLA path and the Pallas kernels in interpret
mode), the two-float arithmetic and the closed-form 3x3 linear algebra.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.ops import jacobian as jjac
from bundleadjustment_benchmarks_tpu.ops import linalg as jlinalg
from bundleadjustment_benchmarks_tpu.ops import pallas_chain
from bundleadjustment_benchmarks_tpu.ops import projection as jproj
from bundleadjustment_benchmarks_tpu.ops import robust as jrobust
from bundleadjustment_benchmarks_tpu.ops import rodrigues as jrod
from bundleadjustment_benchmarks_tpu.ops import twofloat as jtf
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, jacobian, linalg
from bundleadjustment_benchmarks_tpu_torch.ops import projection, robust, rodrigues
from bundleadjustment_benchmarks_tpu_torch.ops import twofloat as tf


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _scaled(a, b):
    """max |a - b| over max(max |b|, 1), the reference package's kernel-test
    measure (tests/test_pallas_chain.py)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0))


@pytest.fixture(scope="module")
def pair():
    # K = 37 * 5 = 185, not a multiple of the Pallas tile (4096) nor of the
    # CUDA block (256): exercises the padding masks.
    jp = make_synthetic_problem(n_cameras=5, n_points=37, obs_per_point=5,
                                seed=3, dtype=jnp.float64)
    return jp, convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def fast_pair(pair):
    jp, tp = pair
    return jpm.to_fast(jp.state), pm.to_fast(tp.state)


def test_f64_residuals_and_energy(pair):
    jp, tp = pair
    r_j = jproj.residuals(jp.state, jp.obs, jp.tau2)
    r_t = projection.residuals(tp.state, tp.obs, tp.tau2)
    print(f"gap f64 residuals: {_rel(r_t, r_j):.3g}")
    assert _rel(r_t, r_j) <= 1e-12
    e_j = float(jproj.energy(jp.state, jp.obs, jp.tau2))
    e_t = float(projection.energy(tp.state, tp.obs, tp.tau2))
    print(f"gap f64 energy: {abs(e_t - e_j) / abs(e_j):.3g}")
    assert abs(e_t - e_j) <= 1e-12 * abs(e_j)


def test_f64_jacobian_blocks(pair):
    """Both packages use the reference's robust factor
    (robust_outer_derivative) in the f64 Jacobian; the gaps are rounding of
    the geometry and the batched products."""
    jp, tp = pair
    b_j = jjac.residuals_and_jacobian(jp.state, jp.obs, jp.tau2)
    b_t = jacobian.residuals_and_jacobian(tp.state, tp.obs, tp.tau2)
    for name in ("Jc", "Jp", "f"):
        gap = _rel(getattr(b_t, name), getattr(b_j, name))
        print(f"gap f64 jacobian {name}: {gap:.3g}")
        assert gap <= 1e-12, (name, gap)


def _robust_residuals(tau2):
    """(K, 2) residuals at the robust factor's edges: exact zeros, tiny
    values (one below its 1e-15 guard on |r|), inliers, |r|^2 == tau2
    exactly, and outliers."""
    rng = np.random.default_rng(11)
    tau = np.sqrt(tau2)
    boundary = np.array([[tau, 0.0], [0.0, -tau], [-tau, 0.0]])
    assert np.all(np.sum(boundary * boundary, -1) == tau2)
    return np.concatenate([
        np.zeros((2, 2)),
        [[1e-12, 0.0], [0.0, -1e-12], [3e-12, -4e-12], [1e-16, 1e-16]],
        rng.uniform(-0.7, 0.7, size=(16, 2)) * tau,
        boundary,
        rng.normal(size=(16, 2)) * 10.0 ** rng.integers(1, 5, size=(16, 1)) * tau,
    ])


@pytest.mark.parametrize("tau2", [0.25, 0.390625, 4.0])
def test_robust_outer_derivative_matches_jax(tau2):
    """The f64 robust factor and residual scale as JAX computes them: within
    1e-15 relative entry by entry, and exactly 0 at r = 0."""
    r = _robust_residuals(tau2)
    if tau2 == 0.390625:  # tau = 5/8: a 3-4-5 triangle on the boundary
        r = np.concatenate([r, [[0.375, 0.5], [-0.5, 0.375]]])
    for name in ("robust_outer_derivative", "robust_scale"):
        want = np.asarray(getattr(jrobust, name)(tau2, jnp.asarray(r)))
        got = _np(getattr(robust, name)(tau2, torch.from_numpy(r)))
        assert got.shape == want.shape
        zero = want == 0.0
        np.testing.assert_array_equal(got[zero], 0.0)
        gap = np.max(np.abs(got - want)[~zero] / np.abs(want[~zero]))
        print(f"gap {name} tau2={tau2}: {gap:.3g}")
        assert gap <= 1e-15, (name, gap)
    assert np.all(_np(robust.robust_outer_derivative(tau2, torch.zeros(1, 2,
                  dtype=torch.float64))) == 0.0)


def test_df32_chain_matches_jax_xla(pair, fast_pair):
    jp, tp = pair
    fj, ft = fast_pair
    b_j = jjac.residuals_and_jacobian_fast(fj, jp.obs, jp.tau2)
    e_j = float(jproj.compensated_square_sum(b_j.f))
    b_t, e_t = cuda_chain.fused_blocks_energy_plain(ft, tp.obs, tp.tau2)
    for name in ("Jc", "Jp", "f"):
        gap = _scaled(getattr(b_t, name), getattr(b_j, name))
        print(f"gap df32 vs XLA {name} (of scale): {gap:.3g}")
        assert gap <= 2e-4, (name, gap)
    print(f"gap df32 vs XLA blocks energy: {abs(float(e_t) - e_j) / abs(e_j):.3g}")
    assert abs(float(e_t) - e_j) <= 1e-5 * abs(e_j)
    e2_j = float(jproj.energy_fast(fj, jp.obs, jp.tau2))
    e2_t = float(cuda_chain.fused_energy_plain(ft, tp.obs, tp.tau2))
    print(f"gap df32 vs XLA trial energy: {abs(e2_t - e2_j) / abs(e2_j):.3g}")
    assert abs(e2_t - e2_j) <= 1e-5 * abs(e2_j)


def test_df32_chain_matches_pallas_interpret(pair, fast_pair):
    """The plain versions of both CUDA kernels against the Pallas kernels
    they replace, run interpreted on the CPU."""
    jp, tp = pair
    fj, ft = fast_pair
    b_j, e_j = pallas_chain.fused_blocks_energy(fj, jp.obs, jp.tau2,
                                                interpret=True)
    b_t, e_t = cuda_chain.fused_blocks_energy(ft, tp.obs, tp.tau2)
    for name in ("Jc", "Jp", "f"):
        gap = _scaled(getattr(b_t, name), getattr(b_j, name))
        print(f"gap df32 vs Pallas interpret {name} (of scale): {gap:.3g}")
        assert gap <= 2e-4, (name, gap)
    gap = abs(float(e_t) - float(e_j)) / abs(float(e_j))
    print(f"gap df32 vs Pallas interpret blocks energy: {gap:.3g}")
    assert gap <= 1e-5
    e2_j = float(pallas_chain.fused_energy(fj, jp.obs, jp.tau2, interpret=True))
    e2_t = float(cuda_chain.fused_energy(ft, tp.obs, tp.tau2))
    print(f"gap df32 vs Pallas interpret trial energy: {abs(e2_t - e2_j) / abs(e2_j):.3g}")
    assert abs(e2_t - e2_j) <= 1e-5 * abs(e2_j)


@pytest.mark.parametrize("valid", [1, 100, 185])
def test_valid_count_masks_the_energy(pair, fast_pair, valid):
    jp, tp = pair
    fj, ft = fast_pair
    e_j = float(pallas_chain.fused_energy(fj, jp.obs, jp.tau2, interpret=True,
                                          valid_count=valid))
    e_t = float(cuda_chain.fused_energy(ft, tp.obs, tp.tau2, valid_count=valid))
    assert abs(e_t - e_j) <= 1e-5 * abs(e_j)
    _, eb_j = pallas_chain.fused_blocks_energy(fj, jp.obs, jp.tau2,
                                               interpret=True, valid_count=valid)
    _, eb_t = cuda_chain.fused_blocks_energy(ft, tp.obs, tp.tau2,
                                             valid_count=valid)
    assert abs(float(eb_t) - float(eb_j)) <= 1e-5 * abs(float(eb_j))


def test_wrappers_take_the_plain_version_on_cpu(pair, fast_pair):
    _, tp = pair
    _, ft = fast_pair
    before = dict(cuda_chain.LAUNCHES)
    cuda_chain.fused_blocks_energy(ft, tp.obs, tp.tau2)
    cuda_chain.fused_energy(ft, tp.obs, tp.tau2)
    assert cuda_chain.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_chain.launch("chain_blocks",
                          cuda_chain.chain_operands(ft, tp.obs), tp.tau2)


def test_chain_operands_are_the_state_tensors(pair, fast_pair):
    """The kernels read the state as it is: no camera pack, no copies."""
    _, tp = pair
    _, ft = fast_pair
    want = (ft.R, ft.T, ft.K, ft.k1, ft.k2, ft.points.hi, ft.points.lo,
            tp.obs.measurements_pl, tp.obs.cam_idx, tp.obs.pt_idx)
    ops = cuda_chain.chain_operands(ft, tp.obs)
    assert len(ops) == len(want)
    assert all(a is b for a, b in zip(ops, want))


@pytest.mark.parametrize("bad,err,match", [
    ("float32", TypeError, "R has dtype"),
    ("noncontiguous", ValueError, "R must be contiguous"),
    ("shape", ValueError, "k1 has shape"),
])
def test_launch_checks_the_cameras(pair, fast_pair, bad, err, match):
    """The wrapper checks every operand before it looks for a card."""
    _, tp = pair
    _, ft = fast_pair
    ops = list(cuda_chain.chain_operands(ft, tp.obs))
    if bad == "float32":
        ops[0] = ops[0].float()
    elif bad == "noncontiguous":
        ops[0] = ops[0].transpose(1, 2)
    else:
        ops[3] = ops[3][:-1]
    with pytest.raises(err, match=match):
        cuda_chain.launch("chain_energy", ops, tp.tau2)


def test_f64_wrappers_equal_plain_on_cpu(pair):
    """On CPU tensors the float64 entry points are the plain chain:
    residuals_and_jacobian's blocks (through planar rows) and energy, and
    projection.energy, bit for bit, with no launch counted."""
    _, tp = pair
    before = dict(cuda_chain.LAUNCHES)
    blocks, energy = cuda_chain.blocks_energy_f64(tp.state, tp.obs, tp.tau2)
    want = jacobian.residuals_and_jacobian(tp.state, tp.obs, tp.tau2)
    for got, ref in zip(blocks, want):
        assert got.shape == ref.shape and torch.equal(got, ref)
    assert torch.equal(energy, projection.compensated_square_sum(want.f))
    assert torch.equal(cuda_chain.energy_f64(tp.state, tp.obs, tp.tau2),
                       projection.energy(tp.state, tp.obs, tp.tau2))
    assert cuda_chain.LAUNCHES == before


def test_f64_blocks_are_views_of_planar_rows(pair):
    """The float64 entry point gives build_context the df32 drive's layout:
    views of (26, K) rows f0 f1, Jc row 0 and 1, Jp row 0 and 1."""
    _, tp = pair
    blocks, _ = cuda_chain.blocks_energy_f64(tp.state, tp.obs, tp.tau2)
    rows, _ = cuda_chain.chain_blocks_f64_plain(tp.state, tp.obs, tp.tau2)
    k = tp.obs.n_observations
    assert rows.shape == (jacobian.PLANAR_CHAIN_ROWS, k)
    assert rows.dtype == torch.float64
    for b in blocks:
        assert b.stride()[0] == 1
    assert torch.equal(rows[0:2], blocks.f.T)
    assert torch.equal(rows[2:11], blocks.Jc[:, 0].T)
    assert torch.equal(rows[11:20], blocks.Jc[:, 1].T)
    assert torch.equal(rows[20:23], blocks.Jp[:, 0].T)
    assert torch.equal(rows[23:26], blocks.Jp[:, 1].T)
    again = jacobian.blocks_from_planar_rows(jacobian.planar_rows_from_blocks(blocks))
    assert all(torch.equal(a, b) for a, b in zip(again, blocks))


def test_f64_operands_are_the_state_tensors(pair):
    _, tp = pair
    s = tp.state
    want = (s.R, s.T, s.K, s.k1, s.k2, s.points, tp.obs.measurements,
            tp.obs.cam_idx, tp.obs.pt_idx)
    ops = cuda_chain.f64_operands(s, tp.obs)
    assert len(ops) == len(want)
    assert all(a is b for a, b in zip(ops, want))


def test_f64_operands_copy_what_is_not_contiguous(pair):
    """The two-phase drive's float64 phase starts from ``from_fast``, whose
    points are a transposed view: the operands are its values, contiguous."""
    _, tp = pair
    state = pm.from_fast(pm.to_fast(tp.state))
    assert not state.points.is_contiguous()
    ops = cuda_chain.f64_operands(state, tp.obs)
    assert all(t.is_contiguous() for t in ops)
    assert torch.equal(ops[5], state.points)


@pytest.mark.parametrize("bad,err,match", [
    ("float32", TypeError, "points has dtype"),
    ("noncontiguous", ValueError, "R must be contiguous"),
    ("planar", ValueError, "measurements has shape"),
    ("cpu", ValueError, "CUDA tensors"),
])
def test_launch_f64_checks_operands(pair, bad, err, match):
    """The float64 launch checks every operand, then refuses CPU tensors."""
    _, tp = pair
    ops = list(cuda_chain.f64_operands(tp.state, tp.obs))
    if bad == "float32":
        ops[5] = ops[5].float()
    elif bad == "noncontiguous":
        ops[0] = ops[0].transpose(1, 2)
    elif bad == "planar":
        ops[6] = ops[6].T.contiguous()
    with pytest.raises(err, match=match):
        cuda_chain.launch_f64("chain_energy_f64", ops, tp.tau2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twofloat_ops_bitwise(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=64) * 10.0 ** rng.integers(-8, 8, size=64)
    b = rng.normal(size=64) * 10.0 ** rng.integers(-8, 8, size=64)
    ja, jb = jtf.from_f64(jnp.asarray(a)), jtf.from_f64(jnp.asarray(b))
    ta, tb = tf.from_f64(torch.from_numpy(a)), tf.from_f64(torch.from_numpy(b))
    for jf, tfn in ((jtf.add, tf.add), (jtf.mul, tf.mul)):
        jr, tr = jf(ja, jb), tfn(ta, tb)
        np.testing.assert_array_equal(_np(tr.hi), np.asarray(jr.hi))
        np.testing.assert_array_equal(_np(tr.lo), np.asarray(jr.lo))
    jr, tr = jtf.sum_df(ja), tf.sum_df(ta)
    assert float(tf.to_f64(tr)) == float(jtf.to_f64(jr))
    np.testing.assert_array_equal(_np(tf.to_f64(ta)), np.asarray(jtf.to_f64(ja)))


def test_rodrigues(pair):
    rng = np.random.default_rng(5)
    w = rng.normal(scale=0.3, size=(16, 3))
    w[0] = 0.0
    w[1] = 1e-7  # Taylor branch
    r_j = jrod.exp_rodrigues(jnp.asarray(w))
    r_t = rodrigues.exp_rodrigues(torch.from_numpy(w))
    print(f"gap rodrigues (abs): {np.max(np.abs(_np(r_t) - np.asarray(r_j))):.3g}")
    assert np.max(np.abs(_np(r_t) - np.asarray(r_j))) <= 1e-15


def _spd_blocks(seed, m=64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, 3, 3)) * 10.0 ** rng.integers(-3, 4, size=(m, 1, 1))
    return A @ np.swapaxes(A, -1, -2) + 1e-3 * np.eye(3)


@pytest.mark.parametrize("clamp", [False, True])
def test_cholesky3x3_and_inverse(clamp):
    V = _spd_blocks(11)
    L_j = jlinalg.cholesky3x3(jnp.asarray(V), clamp=clamp)
    L_t = linalg.cholesky3x3(torch.from_numpy(V), clamp=clamp)
    I_j = jlinalg.inv_lower3x3(L_j)
    I_t = linalg.inv_lower3x3(L_t)
    print(f"gap cholesky3x3 clamp={clamp}: {_rel(L_t, L_j):.3g}, "
          f"inverse {_rel(I_t, I_j):.3g}")
    assert _rel(L_t, L_j) <= 1e-12
    assert _rel(I_t, I_j) <= 1e-12


def test_eigh3x3_sym():
    V = _spd_blocks(12)
    V[0] = np.diag([2.0, 2.0, 2.0])  # fully degenerate
    V[1] = np.diag([1.0, 1.0, 5.0])  # a repeated pair
    e_j, q_j = jlinalg.eigh3x3_sym(jnp.asarray(V))
    e_t, q_t = linalg.eigh3x3_sym(torch.from_numpy(V))
    scale = np.max(np.abs(np.asarray(e_j)), axis=-1, keepdims=True)
    gap = np.max(np.abs(_np(e_t) - np.asarray(e_j)) / scale)
    print(f"gap eigh3x3 eigenvalues (of the block's largest): {gap:.3g}")
    assert gap <= 1e-12
    # Eigenvectors up to sign, per column.
    q_j, q_t = np.asarray(q_j), _np(q_t)
    sign = np.sign(np.sum(q_j * q_t, axis=-2, keepdims=True))
    print(f"gap eigh3x3 eigenvectors: {np.max(np.abs(q_t * sign - q_j)):.3g}")
    assert np.max(np.abs(q_t * sign - q_j)) <= 1e-10

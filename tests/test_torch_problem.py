"""The port's loader, tables, conversion and manifold steps against the JAX
package on the CPU (the in-repo p16 stand-in and a seeded synthetic
problem)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.io import bal as jbal
from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.io import bal
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm

P16 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "data", "problem-16-22106-pre.txt.gz")


@pytest.fixture(scope="module")
def p16():
    return jpm.load_bal_problem(P16), pm.load_bal_problem(P16, device="cpu")


def test_reader_matches(p16):
    ds_j, ds_t = jbal.read_bal(P16), bal.read_bal(P16)
    assert (ds_t.n_cameras, ds_t.n_points, ds_t.n_observations) == (16, 22106, 77392)
    for name in ("cam_idx", "pt_idx", "measurements", "omega", "translation",
                 "focal", "k1", "k2", "points"):
        np.testing.assert_array_equal(getattr(ds_t, name), getattr(ds_j, name))


@pytest.mark.parametrize("name", ["state.K", "state.T", "state.k1", "state.k2",
                                  "state.points", "obs.measurements",
                                  "obs.measurements_pl", "obs.weights"])
def test_loader_values_exact(p16, name):
    d_j = convert.problem_to_numpy(p16[0])
    d_t = convert.problem_to_numpy(p16[1])
    np.testing.assert_array_equal(d_t[name], d_j[name])


def test_loader_rotations(p16):
    """R is the float64 Rodrigues map; XLA and torch evaluate sin/cos with
    different routines, so the two agree to a few ulp, not bitwise."""
    R_j = np.asarray(p16[0].state.R)
    R_t = p16[1].state.R.numpy()
    print(f"gap p16 loader R (abs): {np.max(np.abs(R_t - R_j)):.3g}")
    assert np.max(np.abs(R_t - R_j)) <= 1e-15


def test_loader_tables_equal(p16):
    d_j = convert.problem_to_numpy(p16[0])
    d_t = convert.problem_to_numpy(p16[1])
    int_keys = sorted(k for k, v in d_j.items()
                      if np.asarray(v).dtype.kind == "i")
    assert "pairs.row_a" in int_keys and "cam_banded.aux.0" in int_keys
    assert sorted(k for k, v in d_t.items()
                  if np.asarray(v).dtype.kind == "i") == int_keys
    for k in int_keys:
        assert d_t[k].dtype == np.int32, k
        np.testing.assert_array_equal(d_t[k], d_j[k], err_msg=k)
    assert d_t["inlier_threshold"] == d_j["inlier_threshold"]


def test_convert_roundtrip():
    jp = make_synthetic_problem(n_cameras=4, n_points=12, obs_per_point=3,
                                seed=0, dtype=jnp.float64)
    d = convert.problem_to_numpy(jp)
    tp = convert.problem_from_numpy(d, device="cpu")
    back = convert.problem_to_numpy(tp)
    assert sorted(back) == sorted(d)
    for k, v in d.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)
    st = convert.state_from_numpy(convert.state_to_numpy(jp.state), device="cpu")
    np.testing.assert_array_equal(st.points.numpy(), np.asarray(jp.state.points))


def _step(prob, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=1e-2, size=(prob.n_points, 3)),
            rng.normal(scale=1e-3, size=(prob.n_cameras, 9)))


def test_apply_step_matches():
    jp = make_synthetic_problem(n_cameras=5, n_points=20, obs_per_point=3,
                                seed=4, dtype=jnp.float64)
    tp = convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")
    dxp, dxc = _step(tp, 1)
    s_j = jpm.apply_step(jp.state, jnp.asarray(dxp), jnp.asarray(dxc))
    s_t = pm.apply_step(tp.state, torch.from_numpy(dxp), torch.from_numpy(dxc))
    for name in ("K", "T", "k1", "k2", "points"):
        np.testing.assert_array_equal(getattr(s_t, name).numpy(),
                                      np.asarray(getattr(s_j, name)), err_msg=name)
    assert np.max(np.abs(s_t.R.numpy() - np.asarray(s_j.R))) <= 1e-15


def test_apply_step_fast_matches():
    jp = make_synthetic_problem(n_cameras=5, n_points=20, obs_per_point=3,
                                seed=4, dtype=jnp.float64)
    tp = convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")
    dxp, dxc = _step(tp, 2)
    f_j = jpm.apply_step_fast(jpm.to_fast(jp.state), jnp.asarray(dxp, jnp.float32),
                              jnp.asarray(dxc, jnp.float32))
    f_t = pm.apply_step_fast(pm.to_fast(tp.state),
                             torch.from_numpy(dxp).float(),
                             torch.from_numpy(dxc).float())
    np.testing.assert_array_equal(f_t.points.hi.numpy(), np.asarray(f_j.points.hi))
    np.testing.assert_array_equal(f_t.points.lo.numpy(), np.asarray(f_j.points.lo))
    for name in ("K", "T", "k1", "k2"):
        np.testing.assert_array_equal(getattr(f_t, name).numpy(),
                                      np.asarray(getattr(f_j, name)), err_msg=name)
    back_j, back_t = jpm.from_fast(f_j), pm.from_fast(f_t)
    np.testing.assert_array_equal(back_t.points.numpy(), np.asarray(back_j.points))


def test_bad_file_rejected(tmp_path):
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("2 2 2\n0 0 1.0 2.0\n")
    with pytest.raises(ValueError, match="expected"):
        bal.read_bal(path)

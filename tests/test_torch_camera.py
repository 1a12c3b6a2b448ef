"""The port's camera functions, rotation maps and estimate_norm against the
JAX package's on the same numpy inputs (CPU, float64).

Tolerances: 1e-12 absolute on outputs of order 1-10 (both packages
evaluate the same expressions; matrix products and inverses may round in
another order), 1e-10 for decompose_projection (a QR in LAPACK or XLA, and
a solve). Gaps print with ``pytest -rP``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.models import camera as jcam
from bundleadjustment_benchmarks_tpu.models.problem import BAState as JBAState
from bundleadjustment_benchmarks_tpu.ops import rodrigues as jrod
from bundleadjustment_benchmarks_tpu.solvers import norms as jnorms
from bundleadjustment_benchmarks_tpu_torch.models import camera as tcam
from bundleadjustment_benchmarks_tpu_torch.models.problem import BAState
from bundleadjustment_benchmarks_tpu_torch.ops import rodrigues as trod
from bundleadjustment_benchmarks_tpu_torch.solvers import norms as tnorms

TOL = 1e-12
TOL_DECOMPOSE = 1e-10


def _cameras(seed, batch=(3, 4)):
    """Batched cameras: K upper triangular with a positive diagonal, R a
    rotation, T, world points X in front of them, pixels p, depths, planes."""
    rng = np.random.default_rng(seed)
    K = np.zeros(batch + (3, 3))
    K[..., 0, 0] = rng.uniform(400, 600, batch)
    K[..., 1, 1] = K[..., 0, 0] * rng.uniform(0.9, 1.1, batch)
    K[..., 0, 1] = rng.normal(scale=1.0, size=batch)
    K[..., 0, 2] = rng.normal(scale=20.0, size=batch)
    K[..., 1, 2] = rng.normal(scale=20.0, size=batch)
    K[..., 2, 2] = 1.0
    R = np.asarray(jrod.exp_rodrigues(jnp.asarray(rng.normal(scale=0.5, size=batch + (3,)))))
    T = rng.normal(size=batch + (3,)) + np.array([0.0, 0.0, 4.0])
    return dict(
        K=K, R=R, T=T,
        X=rng.normal(size=batch + (3,)),
        d=rng.normal(size=batch + (3,)),
        p=rng.normal(scale=100.0, size=batch + (2,)),
        depth=rng.uniform(1.0, 5.0, batch),
        plane=np.concatenate([rng.normal(size=batch + (3,)),
                              rng.normal(size=batch + (1,))], axis=-1),
        x=rng.normal(scale=50.0, size=batch),
        y=rng.normal(scale=50.0, size=batch),
    )


#: name -> the argument names it takes.
FUNCTIONS = {
    "camera_center": ("R", "T"),
    "orientation": ("R", "T"),
    "projection_matrix": ("K", "R", "T"),
    "focal_length": ("K",),
    "aspect_ratio": ("K",),
    "principal_point": ("K",),
    "transform_point_into_camera_space": ("R", "T", "X"),
    "transform_point_from_camera_space": ("R", "T", "X"),
    "transform_direction_into_camera_space": ("R", "d"),
    "transform_direction_from_camera_space": ("R", "d"),
    "to_normalized_coordinate": ("K", "p"),
    "from_normalized_coordinate": ("K", "p"),
    "project_point_linear": ("K", "R", "T", "X"),
    "get_ray": ("K", "R", "T", "p"),
    "unproject_pixel": ("K", "R", "T", "p", "depth"),
    "intersect_ray_with_plane": ("K", "R", "T", "plane", "x", "y"),
    "optical_axis": ("R",),
    "up_vector": ("R",),
    "right_vector": ("R",),
    "is_on_good_side": ("R", "T", "X"),
}


def _gap(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("seed", [0, 1])
def test_camera_function_matches_jax(name, seed):
    c = _cameras(seed)
    args = [c[a] for a in FUNCTIONS[name]]
    out_j = getattr(jcam, name)(*(jnp.asarray(a) for a in args))
    out_t = getattr(tcam, name)(*(torch.from_numpy(a) for a in args))
    gap = _gap(out_t, out_j)
    print(f"gap camera.{name} seed {seed}: {gap:.3g}")
    assert gap <= TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decompose_projection_matches_jax(seed):
    """P = K [R | T] -> (K, R, T) in both packages, and back to the
    original factors (K with a positive diagonal, det R = +1)."""
    c = _cameras(seed)
    P = np.asarray(jcam.projection_matrix(*(jnp.asarray(c[a]) for a in "KRT")))
    out_j = jcam.decompose_projection(jnp.asarray(P))
    out_t = tcam.decompose_projection(torch.from_numpy(P))
    gaps = [_gap(t, j) for t, j in zip(out_t, out_j)]
    print(f"gap decompose_projection seed {seed}: K {gaps[0]:.3g}, R {gaps[1]:.3g}, "
          f"T {gaps[2]:.3g}")
    assert max(gaps) <= TOL_DECOMPOSE
    assert max(_gap(t, c[a]) for t, a in zip(out_t, "KRT")) <= TOL_DECOMPOSE


def _rotations(seed):
    """Random rotations, the identity, rotations within 1e-9 of pi about
    random axes and exactly pi about the coordinate axes."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    omegas = np.concatenate([
        rng.normal(scale=0.6, size=(8, 3)),  # angles below pi
        np.zeros((1, 3)),
        axes * (np.pi - 1e-9),
        np.eye(3) * np.pi,
    ])
    return np.array(jrod.exp_rodrigues(jnp.asarray(omegas))), omegas


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternions_match_jax(seed):
    R, _ = _rotations(seed)
    q_j = np.asarray(jrod.quaternion_from_rotation_matrix(jnp.asarray(R)))
    q_t = trod.quaternion_from_rotation_matrix(torch.from_numpy(R))
    R_j = jrod.rotation_matrix_from_quaternion(jnp.asarray(q_j))
    R_t = trod.rotation_matrix_from_quaternion(torch.from_numpy(q_j))
    print(f"gap quaternions seed {seed}: q {_gap(q_t, q_j):.3g}, "
          f"R {_gap(R_t, R_j):.3g}")
    assert _gap(q_t, q_j) <= TOL
    assert _gap(R_t, R_j) <= TOL
    # Back to the rotation: near pi the quaternion's square roots lose half
    # the digits (measured 2.8e-8).
    assert _gap(R_t, R) <= 1e-7
    zero = trod.rotation_matrix_from_quaternion(torch.zeros(4, dtype=torch.float64))
    assert torch.equal(zero, torch.eye(3, dtype=torch.float64))


@pytest.mark.parametrize("seed", [0, 1])
def test_log_rodrigues_matches_jax(seed):
    R, omegas = _rotations(seed)
    w_j = np.asarray(jrod.log_rodrigues(jnp.asarray(R)))
    w_t = trod.log_rodrigues(torch.from_numpy(R))
    gap = _gap(w_t, w_j)
    print(f"gap log_rodrigues seed {seed}: {gap:.3g}")
    assert gap <= TOL
    assert torch.equal(w_t[8], torch.zeros(3, dtype=torch.float64))  # identity
    assert bool(torch.isfinite(w_t).all())
    # Away from pi the log inverts the exponential.
    assert _gap(w_t[:8], omegas[:8]) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_norm_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, m = 5, 17
    R, _ = _rotations(seed)
    arrays = dict(K=np.tile(np.diag([-500.0, -500.0, 1.0]), (n, 1, 1)),
                  R=R[:n], T=rng.normal(size=(n, 3)),
                  k1=rng.normal(scale=1e-2, size=n),
                  k2=rng.normal(scale=1e-3, size=n),
                  points=rng.normal(size=(m, 3)))
    arrays["R"][1] = np.eye(3)  # the identity's log map is 0, not NaN
    diag = rng.uniform(0.5, 2.0, 3 * m + 9 * n)
    v_j = float(jnorms.estimate_norm(
        JBAState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(diag)))
    v_t = tnorms.estimate_norm(
        BAState(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
        torch.from_numpy(diag)).item()
    gap = abs(v_t - v_j) / v_j
    print(f"gap estimate_norm seed {seed}: {gap:.3g} (value {v_t:.17g})")
    assert np.isfinite(v_t) and gap <= TOL

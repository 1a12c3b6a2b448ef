"""The float64 reference against hand computation: the energy of one
observation worked out by hand, and the damped step of a tiny problem
against a dense solve with a finite-difference Jacobian."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import ba


def one_obs_raw(meas):
    return {"cam_idx": np.array([0], np.int32), "pt_idx": np.array([0], np.int32),
            "measurements": np.array([meas], float), "omega": np.zeros((1, 3)),
            "translation": np.array([[0.0, 0.0, 4.0]]), "focal": np.array([100.0]),
            "k1": np.array([1e-6]), "k2": np.array([0.0]),
            "points": np.array([[0.4, -0.2, 1.0]])}


@pytest.mark.parametrize("meas, inlier", [((-8.0, 4.3), True), ((-5.0, 6.0), False)])
def test_energy_by_hand(meas, inlier):
    # X_cam = (0.4, -0.2, 5); xu = (0.08, -0.04); r^2 = 0.008;
    # k1 f^2 = 1e-2; kr = 1.00008; f = -100: p = (-8.00064, 4.00032).
    prob, s = ba.from_raw(one_obs_raw(meas), 0.5, "cpu")
    p = (-100 * 1.00008 * 0.08, -100 * 1.00008 * -0.04)
    r2 = (p[0] - meas[0]) ** 2 + (p[1] - meas[1]) ** 2
    tau2 = 0.25
    want = r2 * (2 - r2 / tau2) / 4 if r2 < tau2 else tau2 / 4
    assert (r2 < tau2) == inlier
    assert ba.energy(s, prob) == pytest.approx(want, rel=1e-12)


def tiny():
    rng = np.random.default_rng(4)
    n, m = 3, 8
    cam = np.repeat(np.arange(n), m)
    pt = np.tile(np.arange(m), n)
    X = rng.normal(size=(m, 3)) * 0.5
    omega = rng.normal(size=(n, 3)) * 0.05
    T = np.column_stack([rng.normal(size=(n, 2)) * 0.2, np.full(n, 5.0)])
    raw = {"cam_idx": cam.astype(np.int32), "pt_idx": pt.astype(np.int32),
           "omega": omega, "translation": T, "focal": np.full(n, 300.0),
           "k1": np.full(n, 1e-7), "k2": np.full(n, 1e-13), "points": X,
           "measurements": np.zeros((n * m, 2))}
    prob, s = ba.from_raw(raw, 2.0, "cpu")
    prob.meas = ba.residuals(s, prob) + torch.from_numpy(
        rng.normal(scale=0.6, size=(n * m, 2)))
    return prob, s


def flat(s):
    return torch.cat([torch.cat([s.T, torch.zeros_like(s.T), s.f[:, None],
                                 s.k1[:, None], s.k2[:, None]], 1).reshape(-1),
                      s.X.reshape(-1)])


def robust_f(s, prob):
    r = ba.residuals(s, prob)
    n2 = (r * r).sum(-1)
    return (r * torch.sqrt(ba.psi(n2, prob.tau2) / n2)[:, None]).reshape(-1)


def numeric_jacobian(s, prob, h=1e-6):
    n, m = prob.n_cameras, prob.n_points
    cols = []
    for j in range(9 * n + 3 * m):
        dc = torch.zeros(n, 9, dtype=torch.float64)
        dX = torch.zeros(m, 3, dtype=torch.float64)
        if j < 9 * n:
            dc.view(-1)[j] = h
        else:
            dX.view(-1)[j - 9 * n] = h
        fp = robust_f(ba.apply_step(s, dX, dc), prob)
        fm = robust_f(ba.apply_step(s, -dX, -dc), prob)
        cols.append((fp - fm) / (2 * h))
    return torch.stack(cols, 1)


def test_blocks_match_finite_differences():
    prob, s = tiny()
    f, Jc, Jp = ba.blocks(s, prob)
    J = numeric_jacobian(s, prob)
    n = prob.n_cameras
    assert torch.allclose(f.reshape(-1), robust_f(s, prob), rtol=1e-12, atol=1e-12)
    for k in range(prob.n_observations):
        c, p = int(prob.cam[k]), int(prob.pt[k])
        got = J[2 * k:2 * k + 2]
        assert torch.allclose(Jc[k], got[:, 9 * c:9 * c + 9], rtol=1e-5, atol=1e-6)
        assert torch.allclose(Jp[k], got[:, 9 * n + 3 * p:9 * n + 3 * p + 3],
                              rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lam", [1e-2, 10.0])
def test_damped_step_against_a_dense_solve(lam):
    prob, s = tiny()
    f, Jc, Jp = ba.blocks(s, prob)
    n, m = prob.n_cameras, prob.n_points
    J = torch.zeros(2 * prob.n_observations, 9 * n + 3 * m, dtype=torch.float64)
    for k in range(prob.n_observations):
        c, p = int(prob.cam[k]), int(prob.pt[k])
        J[2 * k:2 * k + 2, 9 * c:9 * c + 9] = Jc[k]
        J[2 * k:2 * k + 2, 9 * n + 3 * p:9 * n + 3 * p + 3] = Jp[k]
    A = J.T @ J + lam * torch.eye(J.shape[1], dtype=torch.float64)
    want = torch.linalg.solve(A, -J.T @ f.reshape(-1))
    dX, dc = ba.damped_step(ba.normal(s, prob), lam, prob)
    got = torch.cat([dc.reshape(-1), dX.reshape(-1)])
    assert torch.allclose(got, want, rtol=1e-8, atol=1e-10 * float(want.abs().max()))
    assert ba.backward_error(s, prob, lam, dX, dc) < 1e-13
    assert ba.backward_error(s, prob, lam, 1.01 * dX, 1.01 * dc) > 1e-4


def test_lm_iteration_rules():
    prob, s = tiny()
    ne = ba.normal(s, prob)
    it = ba.lm_iteration(s, prob, None, "cholesky")
    assert it.lam0 == pytest.approx(1e-12 * ne.max_diag, rel=1e-15)
    assert it.accepted and it.energy < ba.energy(s, prob)
    assert ba.growth(2.0, 0) == 2.0 and ba.growth(2.0, 2) == pytest.approx(2.0 ** 2.25)
    assert math.isinf(ba.growth(2.0, 200))


def test_log_inverts_exp():
    w = torch.tensor([[1e-9, -2e-9, 3e-9], [0.3, -0.2, 0.1], [0.0, 0.0, 0.0]],
                     dtype=torch.float64)
    assert torch.allclose(ba.log_so3(ba.exp_so3(w)), w, rtol=1e-9, atol=1e-20)

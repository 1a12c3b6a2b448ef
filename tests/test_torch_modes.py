"""The port's four other solver modes (qrchol, moreqr, qrkit, spqr) against
the JAX package on the CPU, float64.

Both sides get the same Jacobian blocks (computed by the JAX package and
carried across), so the comparisons isolate the Schur engine. Each
realization of qrkit ("rows", "gram", "pair") and spqr ("tsqr", "gram") is
reached in JAX as its own CPU tests reach it: "rows" and "tsqr" are its
defaults off the TPU, "gram" re-damps the rows cache with
``BA_QRKIT_GRAM=1`` set, "pair" is ``build_context(force_qr_pair=True)``
and spqr "gram" is ``_spqr_gram_solve``. In the port the problem picks
qrkit's cache ("pair" with pair tables, "rows" on a copy without them),
spqr runs "gram", and qrkit "gram" and spqr "tsqr" are the private
reference ``_reference_step``. QR factors are
compared through sign-free products: the libraries choose R's row signs
differently. Run with ``pytest -rP`` to see every measured gap.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.ops import jacobian as jjac
from bundleadjustment_benchmarks_tpu.ops import linalg as jlinalg
from bundleadjustment_benchmarks_tpu.solvers import schur as jschur
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import linalg
from bundleadjustment_benchmarks_tpu_torch.ops.jacobian import JacobianBlocks
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur

#: (mode, realization) pairs: every way the port solves a damped system.
REALIZATIONS = [("cholesky", None), ("qrchol", None), ("moreqr", None),
                ("qrkit", "rows"), ("qrkit", "gram"), ("qrkit", "pair"),
                ("spqr", "tsqr"), ("spqr", "gram")]
IDS = [m if f is None else f"{m}-{f}" for m, f in REALIZATIONS]
#: Step tolerance against JAX: the chol camera solver's refined solves
#: agree to 1e-9 relative, the QR realizations to 1e-7.
STEP_RTOL = {"chol": 1e-9, "qr_cached": 1e-7, "qr_full": 1e-7}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _pair(**kw):
    jp = make_synthetic_problem(dtype=jnp.float64, **kw)
    tp = convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")
    b_j = jjac.residuals_and_jacobian(jp.state, jp.obs, jp.tau2)
    b_t = JacobianBlocks(*(torch.from_numpy(np.array(x)) for x in b_j))
    return jp, tp, b_j, b_t


class _Case:
    """One problem in both packages, with contexts built on demand."""

    def __init__(self, **kw):
        self.jp, self.tp, self.b_j, self.b_t = _pair(**kw)
        self._ctx = {}

    def port_problem(self, mode, form):
        """qrkit's dense cache ("rows", "gram") is the port's path on a
        problem without pair tables: a copy of this one without them."""
        if mode == "qrkit" and form in ("rows", "gram"):
            return dataclasses.replace(self.tp, pairs=None)
        return self.tp

    def contexts(self, mode, form=None):
        key = (mode, "rows" if (mode, form) == ("qrkit", "gram") else form)
        if key not in self._ctx:
            pair = mode == "qrkit" and form == "pair"
            self._ctx[key] = (
                jschur.build_context(self.b_j, self.jp, mode, force_qr_pair=pair),
                schur.build_context(self.b_t, self.port_problem(mode, form), mode))
        return self._ctx[key]

    def jax_step(self, mode, form, lam, monkeypatch):
        """JAX's step for one realization, as its own CPU tests reach it."""
        ctx_j, _ = self.contexts(mode, form)
        jp = self.jp
        if mode == "spqr" and form == "gram":
            n = jp.n_cameras
            dxc = jschur._spqr_gram_solve(ctx_j, lam, jp, n).reshape(n, 9)
            Linv = jschur._point_factor_inv(ctx_j, jnp.asarray(lam), mode,
                                            jnp.float64)
            t = ctx_j.g_pts - jschur.point_coupling_sum(
                ctx_j.W, dxc, jp.obs.cam_idx, jp)
            y = jnp.einsum("mij,mj->mi", Linv, t)
            return jnp.einsum("mji,mj->mi", Linv, y), dxc
        with monkeypatch.context() as mp:
            if mode == "qrkit" and form == "gram":
                mp.setenv("BA_QRKIT_GRAM", "1")
            return jschur.solve_damped(ctx_j, lam, jp, mode)

    def port_step(self, mode, form, lam):
        _, ctx_t = self.contexts(mode, form)
        tp = self.port_problem(mode, form)
        if (mode, form) in (("qrkit", "gram"), ("spqr", "tsqr")):
            return schur._reference_step(ctx_t, lam, tp, mode)
        return schur.solve_damped(ctx_t, lam, tp, mode)


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def case(request):
    return _Case(n_cameras=6, n_points=40, obs_per_point=4, seed=request.param)


@pytest.fixture(scope="module")
def case0():
    return _Case(n_cameras=6, n_points=40, obs_per_point=4, seed=0)


@pytest.fixture(scope="module")
def once():
    """Every point seen once: no pair tables, rank-2 point blocks."""
    c = _Case(n_cameras=3, n_points=8, obs_per_point=1, seed=1)
    assert c.jp.pairs is None and c.tp.pairs is None
    return c


def _dense(b_j, jp, lam):
    """Dense float64 damped system (A, rhs) from the JAX blocks."""
    Jc, Jp, f = (np.asarray(x) for x in b_j)
    n, m, k = jp.n_cameras, jp.n_points, Jc.shape[0]
    cam, pt = np.asarray(jp.obs.cam_idx), np.asarray(jp.obs.pt_idx)
    J = np.zeros((2 * k, 3 * m + 9 * n))
    for i in range(k):
        J[2 * i:2 * i + 2, 3 * pt[i]:3 * pt[i] + 3] = Jp[i]
        J[2 * i:2 * i + 2, 3 * m + 9 * cam[i]:3 * m + 9 * cam[i] + 9] = Jc[i]
    return J.T @ J + lam * np.eye(J.shape[1]), -J.T @ f.reshape(-1)


def _flat(dxp, dxc):
    return np.concatenate([_np(dxp).reshape(-1), _np(dxc).reshape(-1)])


def _dense_step(b_j, jp, lam):
    """The damped step from the dense normal equations (numpy float64)."""
    A, rhs = _dense(b_j, jp, lam)
    x = np.linalg.solve(A, rhs)
    m = jp.n_points
    return x[:3 * m].reshape(m, 3), x[3 * m:].reshape(-1, 9), np.linalg.cond(A)


# -- ops/linalg.py ------------------------------------------------------------------


@pytest.mark.parametrize("what", ["mgs_qr3", "mgs_qr3_zero_deficient",
                                  "solve_upper_triangular"])
def test_linalg_matches_jax(what):
    rng = np.random.default_rng(4)
    if what.startswith("mgs_qr3"):
        A = rng.normal(size=(50, 9, 3))
        deficient = what.endswith("deficient")
        if deficient:  # rank 2 and rank 1 blocks, as points seen once give
            A[:20, :, 2] = A[:20, :, 0] - 2.0 * A[:20, :, 1]
            A[20:25, 2:] = 0.0
            A[20:25, :2, 1:] = A[20:25, :2, :1] * np.array([3.0, -1.0])
        Q_j, R_j = jlinalg.mgs_qr3(jnp.asarray(A), zero_deficient=deficient)
        Q_t, R_t = linalg.mgs_qr3(torch.from_numpy(A), zero_deficient=deficient)
        gap = max(_rel(Q_t, Q_j), _rel(R_t, R_j))
        if deficient:
            assert np.array_equal(_np(R_t)[:, 2, 2] == 0, np.asarray(R_j)[:, 2, 2] == 0)
            assert (_np(R_t)[:20, 2, 2] == 0).all()
    else:
        R = np.triu(rng.normal(size=(30, 30))) + 30.0 * np.eye(30)
        b = rng.normal(size=30)
        gap = _rel(linalg.solve_upper_triangular(torch.from_numpy(R),
                                                 torch.from_numpy(b)),
                   jlinalg.solve_upper_triangular(jnp.asarray(R), jnp.asarray(b)))
    print(f"gap linalg {what}: {gap:.3g}")
    assert gap <= 1e-12


@pytest.mark.parametrize("weighted", [False, True])
def test_chunked_gram_matches_jax(weighted):
    """The gram of problems without pair tables, on random blocks."""
    c = _Case(n_cameras=5, n_points=30, obs_per_point=3, seed=2)
    jp, tp = c.jp, c.tp
    rng = np.random.default_rng(3)
    C = rng.normal(size=(jp.n_observations, 9, 3))
    y = rng.normal(size=(jp.n_points, 3))
    w = rng.uniform(0.1, 2.0, size=(jp.n_points, 3)) if weighted else None
    S_j, b_j = jschur._schur_gram_chunked(
        jnp.asarray(C), None if w is None else jnp.asarray(w), jnp.asarray(y),
        jp.obs.cam_idx, jp.pt_obs_idx, jp.n_cameras, jnp.float64)
    S_t, b_t = schur._schur_gram_chunked(
        torch.from_numpy(C), None if w is None else torch.from_numpy(w),
        torch.from_numpy(y), tp.obs.cam_idx, tp.pt_obs_idx, tp.n_cameras,
        torch.float64)
    print(f"gap chunked gram weighted={weighted}: S {_rel(S_t, S_j):.3g}, "
          f"b {_rel(b_t, b_j):.3g}")
    assert _rel(S_t, S_j) <= 1e-12 and _rel(b_t, b_j) <= 1e-12


# -- the context -------------------------------------------------------------------


def _field(case, field):
    """(port, JAX) values of a context field, or of a sign-free product of
    it where the QR and eigenvector signs are the libraries' choice."""
    if field in ("Jc_stacked", "rhs_stacked"):
        j, t = case.contexts("spqr")
        return getattr(t, field), getattr(j, field)
    if field == "Jp_stacked":
        j, t = case.contexts("qrchol")
        return t.Jp_stacked, j.Jp_stacked
    if field in ("qr_S0cam", "qr_b0"):
        j, t = case.contexts("qrkit", "pair")
        return getattr(t, field), getattr(j, field)
    if field == "pair_stack_products":
        j, t = case.contexts("qrkit", "pair")
        prod = [np.einsum("icl,jcl->ijl", _np(c.pairA).reshape(9, 3, -1),
                          _np(c.pairB).reshape(9, 3, -1)) for c in (t, j)]
        return prod[0], prod[1]
    j, t = case.contexts("qrkit", "rows")
    if field == "fill_evals":
        return t.fill_evals, j.fill_evals
    if field == "QtRpc_point_grams":
        return (np.einsum("mci,mcj->mij", _np(c.QtRpc), _np(c.QtRpc))
                for c in (t, j))
    assert field == "Rcc_aug_gram"
    return (_np(c.Rcc_aug).T @ _np(c.Rcc_aug) for c in (t, j))


@pytest.mark.parametrize("field", [
    "Jp_stacked", "Jc_stacked", "rhs_stacked", "fill_evals", "qr_S0cam",
    "qr_b0", "pair_stack_products", "QtRpc_point_grams", "Rcc_aug_gram"])
def test_context_fields(case, field):
    got, want = _field(case, field)
    gap = _rel(got, want)
    print(f"gap context {field}: {gap:.3g}")
    assert gap <= 1e-9


def test_context_holds_what_the_mode_needs(case0):
    """Each mode builds its own cache and no other; qrkit's follows the
    problem's pair tables."""
    _, t = case0.contexts("qrkit", "rows")
    assert t.QtRpc is not None and t.Rcc_aug is not None and t.pairA is None
    assert t.qr_S0cam is None
    _, t = case0.contexts("qrkit", "pair")
    assert t.QtRpc is None and t.Jc_stacked is None and t.qr_S0cam is not None
    _, t = case0.contexts("spqr")
    assert t.Jc_stacked is not None and t.evals is None and t.pairA is None
    _, t = case0.contexts("moreqr")
    assert t.pairA is not None and t.Jp_stacked is None and t.WQ is None


# -- the damped solve -----------------------------------------------------------------


@pytest.mark.parametrize("lam", [1e-2, 1e2])
@pytest.mark.parametrize("mode,form", REALIZATIONS, ids=IDS)
def test_solve_damped_matches_jax(case, mode, form, lam, monkeypatch):
    dxp_j, dxc_j = case.jax_step(mode, form, lam, monkeypatch)
    dxp_t, dxc_t = case.port_step(mode, form, lam)
    tol = STEP_RTOL[schur.MODE_STRATEGY[mode][1]]
    print(f"gap solve_damped {mode} {form} lam={lam}: dxc {_rel(dxc_t, dxc_j):.3g}, "
          f"dxp {_rel(dxp_t, dxp_j):.3g} (tolerance {tol:g})")
    assert _rel(dxc_t, dxc_j) <= tol
    assert _rel(dxp_t, dxp_j) <= tol


@pytest.mark.parametrize("lam", [1e-4, 1e-2])
@pytest.mark.parametrize("mode,form", REALIZATIONS, ids=IDS)
def test_solve_damped_as_accurate_as_jax(case0, mode, form, lam, monkeypatch):
    """Against the dense float64 solve, the port's step is no farther off
    than twice JAX's (condition numbers ~1e8-1e10 here)."""
    xp, xc, cond = _dense_step(case0.b_j, case0.jp, lam)
    want = _flat(xp, xc)
    got_j = _flat(*case0.jax_step(mode, form, lam, monkeypatch))
    got_t = _flat(*case0.port_step(mode, form, lam))
    print(f"gap dense solve {mode} {form} lam={lam} cond={cond:.3g}: port "
          f"{_rel(got_t, want):.3g}, JAX {_rel(got_j, want):.3g}, "
          f"port-JAX {_rel(got_t, got_j):.3g}")
    assert _rel(got_t, want) <= 2.0 * _rel(got_j, want) + 1e-12


@pytest.mark.parametrize("mode", schur.MODES)
def test_initial_lambda(case0, mode):
    form = "rows" if mode == "qrkit" else None
    ctx_j, ctx_t = case0.contexts(mode, form)
    l_j = float(jschur.initial_lambda(ctx_j, mode))
    l_t = float(schur.initial_lambda(ctx_t, mode))
    print(f"gap initial_lambda {mode}: {abs(l_t - l_j) / l_j:.3g} ({l_t:.6g})")
    assert abs(l_t - l_j) <= 1e-12 * l_j


@pytest.mark.parametrize("form", ["rows", "gram", "pair"])
def test_qrkit_cache_is_lambda_free(form, monkeypatch):
    """One qrkit context serves every damping trial (More's factor-once):
    each step solves the damped system and matches JAX's."""
    c = _Case(n_cameras=4, n_points=10, obs_per_point=3, seed=7)
    for lam in (1e-5, 3e-2, 7.0):
        A, rhs = _dense(c.b_j, c.jp, lam)
        dx = _flat(*c.port_step("qrkit", form, lam))
        res = np.linalg.norm(A @ dx - rhs) / np.linalg.norm(rhs)
        gap = _rel(dx, _flat(*c.jax_step("qrkit", form, lam, monkeypatch)))
        print(f"gap qrkit {form} lam={lam}: residual {res:.3g}, port-JAX {gap:.3g}")
        assert res <= 1e-7
        assert gap <= STEP_RTOL["qr_cached"]


P16 = Path(__file__).resolve().parents[1] / "data" / "problem-16-22106-pre.txt.gz"


def test_moreqr_point_step_on_p16():
    """moreqr's point step by the closed-form eigenbasis of V against the
    exact per-point solve (V + lam I)^-1 t, on p16 at lambda = 1e4 x
    cholesky's initial lambda: the port and JAX on the same float64 blocks
    take the same step (1e-9), and the port's lies no farther from the
    exact solve than twice JAX's. The card-against-CPU tolerance of the
    CUDA test is set from this distance."""
    jp = jpm.load_bal_problem(str(P16))
    tp = pm.load_bal_problem(str(P16), device="cpu")
    b_j = jjac.residuals_and_jacobian(jp.state, jp.obs, jp.tau2)
    b_t = JacobianBlocks(*(torch.from_numpy(np.array(x)) for x in b_j))
    ctx_j = {m: jschur.build_context(b_j, jp, m) for m in ("cholesky", "moreqr")}
    ctx_t = {m: schur.build_context(b_t, tp, m) for m in ("cholesky", "moreqr")}
    lam = 1e4 * float(jschur.initial_lambda(ctx_j["cholesky"], "cholesky"))
    dxp_j = {m: jschur.solve_damped(ctx_j[m], lam, jp, m)[0] for m in ctx_j}
    step_t = {m: schur.solve_damped(ctx_t[m], lam, tp, m) for m in ctx_t}
    c = ctx_t["moreqr"]
    t = c.g_pts - schur.point_coupling_sum(c.W, step_t["moreqr"][1],
                                           tp.obs.cam_idx, tp)
    eye3 = torch.eye(3, dtype=c.V.dtype)
    exact = torch.linalg.solve(c.V + lam * eye3, t[..., None])[..., 0]
    gap_t, gap_j = _rel(step_t["moreqr"][0], exact), _rel(dxp_j["moreqr"], exact)
    print(f"gap p16 moreqr dxp lam={lam:.6g}: port-JAX "
          f"{_rel(step_t['moreqr'][0], dxp_j['moreqr']):.3g}; to the exact "
          f"solve port {gap_t:.3g}, JAX {gap_j:.3g}; cholesky to it "
          f"{_rel(step_t['cholesky'][0], exact):.3g}; JAX moreqr-cholesky "
          f"{_rel(dxp_j['moreqr'], dxp_j['cholesky']):.3g}")
    assert _rel(step_t["moreqr"][0], dxp_j["moreqr"]) <= 1e-9
    assert gap_t <= 2.0 * gap_j + 1e-12


# -- points seen once (no pair tables) ----------------------------------------------


@pytest.mark.parametrize("mode,form", [r for r in REALIZATIONS if r[1] != "pair"],
                         ids=[i for i in IDS if i != "qrkit-pair"])
def test_points_seen_once(once, mode, form, monkeypatch):
    """Without pair tables the chol camera solver runs the chunked dense
    gram (moreqr on the cached W Q) and qrkit its rank-guarded QR. The
    linear residual is held at JAX's own rank-deficient lambdas (1e-4, 1);
    the steps against JAX at lambda 1e2. Here qrkit's lambda-free reduced
    system is 0 in exact arithmetic (each point's two rows absorb its
    camera rows), so its factor is the square root of rounding noise in
    either package and the two steps differ by that noise over lambda:
    1.2e-5 at 1e-2, 1.2e-7 at 1, 1.2e-9 at 1e2 on this problem."""
    for lam in (1e-4, 1.0):
        A, rhs = _dense(once.b_j, once.jp, lam)
        dx = _flat(*once.port_step(mode, form, lam))
        assert np.isfinite(dx).all()
        res = np.linalg.norm(A @ dx - rhs) / np.linalg.norm(rhs)
        print(f"gap points seen once {mode} {form} lam={lam}: residual {res:.3g}")
        assert res <= 1e-7
    lam = 1e2
    got = _flat(*once.port_step(mode, form, lam))
    want = _flat(*once.jax_step(mode, form, lam, monkeypatch))
    tol = STEP_RTOL[schur.MODE_STRATEGY[mode][1]]
    print(f"gap points seen once {mode} {form} lam={lam}: port-JAX "
          f"{_rel(got, want):.3g} (tolerance {tol:g})")
    assert _rel(got, want) <= tol
    if mode == "moreqr":
        ctx_j, ctx_t = once.contexts(mode)
        sign = np.sign(np.sum(_np(ctx_t.evecs) * np.asarray(ctx_j.evecs), axis=-2))
        pt = np.asarray(once.jp.obs.pt_idx)
        assert _rel(_np(ctx_t.WQ) * sign[pt][:, None, :], ctx_j.WQ) <= 1e-9


def test_qrkit_without_pair_tables_caches_rows(once):
    """Where no point is seen twice, qrkit caches the dense rows."""
    t = schur.build_context(once.b_t, once.tp, "qrkit")
    assert t.QtRpc is not None and t.qr_S0cam is None and t.pairA is None


@pytest.mark.parametrize("mode", schur.MODES)
def test_minimize_points_seen_once(once, mode):
    """lm.minimize runs every mode on both drives without pair tables."""
    e0 = float(lm._prepare(once.tp.state, once.tp, mode)[1])
    for cfg in (lm.LMConfig(drive="host", max_iter=4),
                lm.LMConfig(drive="host", max_iter=4, matmul_dtype="float32",
                            geometry="df32")):
        res = lm.minimize(once.tp, mode=mode, config=cfg, device="cpu")
        print(f"points seen once {mode} geometry={cfg.geometry}: energy "
              f"{e0:.6g} -> {res.energy:.6g} in {res.iterations} iterations")
        assert np.isfinite(res.energy) and res.energy < e0
        assert torch.isfinite(res.state.points).all()


# -- refine_step ---------------------------------------------------------------------


@pytest.mark.parametrize("mode", schur.MODES)
def test_refine_step(case0, mode):
    """One refinement pass matches JAX's for the chol camera solver; qrkit
    and spqr raise, in refine_step and in lm.minimize (JAX would add their
    camera step a second time)."""
    lam = 1e-2
    form = "rows" if mode == "qrkit" else None
    ctx_j, ctx_t = case0.contexts(mode, form)
    dxp_t, dxc_t = schur.solve_damped(ctx_t, lam, case0.tp, mode)
    if schur.MODE_STRATEGY[mode][1] != "chol":
        with pytest.raises(ValueError, match="refine_step supports"):
            schur.refine_step(ctx_t, lam, case0.tp, mode, dxp_t, dxc_t)
        with pytest.raises(ValueError, match="refine_steps=1"):
            lm.minimize(case0.tp, mode=mode, device="cpu",
                        config=lm.LMConfig(drive="host", max_iter=1, refine_steps=1))
        return
    dxp_j, dxc_j = jschur.solve_damped(ctx_j, lam, case0.jp, mode)
    rp_j, rc_j = jschur.refine_step(ctx_j, lam, case0.jp, mode, dxp_j, dxc_j)
    rp_t, rc_t = schur.refine_step(ctx_t, lam, case0.tp, mode, dxp_t, dxc_t)
    print(f"gap refine_step {mode}: dxc {_rel(rc_t, rc_j):.3g}, "
          f"dxp {_rel(rp_t, rp_j):.3g}")
    assert _rel(rc_t, rc_j) <= 1e-9 and _rel(rp_t, rp_j) <= 1e-9
    res = lm.minimize(case0.tp, mode=mode, device="cpu",
                      config=lm.LMConfig(drive="host", max_iter=3, refine_steps=1))
    assert np.isfinite(res.energy)

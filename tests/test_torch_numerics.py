"""Gate (e) of ``bench_torch.py``, "numerics": ``bench_torch.numerics_gate``
holds every accepted step of a run to the damped normal equations at the
state before it, and every accepted energy to the float64 energy of the
state after it, from the states that ``lm.minimize(..., states=...)``
hands over.

- (e1) ``recover_step`` gives back the step that ``apply_step`` and
  ``apply_step_fast`` applied, within 1e-12 of its norm, rotations near
  the identity included (where ``rodrigues.log_rodrigues`` keeps half the
  digits).
- (e2) ``step_residual``: a float64 step of every mode, and the df32
  step of the plain chain, lie within their geometry's bound on eta, the
  Jacobi-scaled backward error; the float64 step scaled by 1 + 1e-3
  lies 10x past the float64 bound, the df32 step scaled by 1 +
  ``STEP_FAULT_DF32`` 10x past the df32 bound; the port's df32 step is as
  good as the JAX package's at the same state (both under the bound, the
  port's largest eta within 2x of JAX's).
- The observer: the jit drive's states equal the host drive's bit for
  bit, one read per iteration; a flatline stop's discarded step is not
  checked.
- ``numerics_gate`` passes a clean p16 float64 cholesky run of 20
  iterations on the host drive and fails it under ``step-scaled`` while
  gate (d3) passes that run; ``energy-scaled`` fails a df32 run on (e3)
  alone; the checker runs with the solve's functions patched to raise.

Tolerances are the gate's own (``bench_torch.NUMERICS_BOUNDS``), and
1e-12 of the step's norm for (e1).
"""

import contextlib
import dataclasses
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu.solvers import schur as jschur
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
from bundleadjustment_benchmarks_tpu_torch.utils import balgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch as bench  # noqa: E402
import flatline_campaign as campaign  # noqa: E402

F64, DF32 = bench.NUMERICS_BOUNDS["f64"], bench.NUMERICS_BOUNDS["df32"]
#: The generated problem of tests/test_torch_control.py: (cameras, points).
GEN = (12, 300)
GEN_KW = dict(seed=2, mean_degree=4.3)
STATUS = lm.STATUS_STRINGS


@pytest.fixture(scope="module")
def generated():
    return pm.from_bal_dataset(balgen.generate_bal_like(*GEN, **GEN_KW),
                               device="cpu")


def observed(problem, cfg, drive="host", mode="cholesky"):
    """(result, records, states) of one observed port run."""
    records, states = [], []
    res = lm.minimize(problem, mode, dataclasses.replace(cfg, drive=drive),
                      device="cpu", records=records,
                      states=lambda *s: states.append(s))
    return res, records, states


def gate(problem, cfg, res, states):
    return bench.numerics_gate(problem, bench.start_state(problem, cfg), states,
                               cfg, STATUS[res.status])


# -- (e1) the step recovered from two states ----------------------------------------


def _step(problem, rot_scale: float, seed: int):
    """A step from a numpy generator: points, T, f, k1 and k2 moved by ~1e-2
    of their own size, rotations of norm ``rot_scale``."""
    rng = np.random.default_rng(seed)
    s = problem.state
    n, m = problem.n_cameras, problem.n_points
    size = torch.cat([s.T.abs(), torch.zeros((n, 3), dtype=s.T.dtype),
                      s.K[:, 0, 0].abs()[:, None], s.k1.abs()[:, None],
                      s.k2.abs()[:, None]], dim=1).numpy()
    dxc = rng.normal(size=(n, 9)) * 1e-2 * size
    w = rng.normal(size=(n, 3))
    dxc[:, 3:6] = w / np.linalg.norm(w, axis=1, keepdims=True) * rot_scale
    dxp = rng.normal(size=(m, 3)) * 1e-2 * s.points.abs().numpy()
    return torch.from_numpy(dxp), torch.from_numpy(dxc)


def _gap(got, want):
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("rot_scale", [1e-2, 1e-6, 1e-9, 0.0])
@pytest.mark.parametrize("geometry", ["f64", "df32"])
def test_recovered_step_is_the_applied_one(generated, geometry, rot_scale):
    """The step ``recover_step`` reads off the states before and after an
    update equals the step the update applied, within 1e-12 of its norm,
    and so does its rotation block, down to rotations of 1e-9 and 0."""
    dxp, dxc = _step(generated, rot_scale, seed=int(rot_scale * 1e9) + 7)
    if geometry == "f64":
        prev = generated.state
        cur = pm.apply_step(prev, dxp, dxc)
    else:
        fast = pm.to_fast(generated.state)
        dxp = dxp.to(torch.float32).to(torch.float64)
        prev = pm.from_fast(fast, dtype=torch.float64)
        cur = pm.from_fast(pm.apply_step_fast(fast, dxp, dxc), dtype=torch.float64)
    rxp, rxc = bench.recover_step(prev, cur)
    whole = _gap(torch.cat([rxp.flatten(), rxc.flatten()]),
                 torch.cat([dxp.flatten(), dxc.flatten()]))
    rot = float(torch.linalg.vector_norm(rxc[:, 3:6] - dxc[:, 3:6])
                / torch.linalg.vector_norm(dxc))
    err_p, err_c = bench.recovery_err(prev, cur, geometry)
    print(f"{geometry} rotations {rot_scale:g}: step {whole:.3g}, rotations {rot:.3g}")
    assert whole <= 1e-12 and rot <= 1e-12
    assert bool(((rxp - dxp).abs() <= err_p).all() and ((rxc - dxc).abs() <= err_c).all())


def test_log_rotation_near_the_identity():
    """``log_rotation`` of exp(w) returns w within 1e-14 of |w| for |w| from
    1 down to 1e-12, where the quaternion route of ``log_rodrigues`` loses
    about half of the digits (printed)."""
    from bundleadjustment_benchmarks_tpu_torch.ops import rodrigues

    rng = np.random.default_rng(3)
    for scale in (1.0, 1e-4, 1e-8, 1e-12):
        d = rng.normal(size=(64, 3))
        w = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True)
                             * rng.uniform(0.1, 1.0, size=(64, 1)) * scale)
        got = bench.log_rotation(rodrigues.exp_rodrigues(w))
        rel = float(((got - w).norm(dim=1) / w.norm(dim=1)).max())
        quat = float((rodrigues.log_rodrigues(rodrigues.exp_rodrigues(w)) - w).norm(dim=1).max())
        print(f"|w| ~ {scale:g}: log_rotation {rel:.3g} relative, log_rodrigues {quat:.3g} absolute")
        assert rel <= 1e-14


# -- (e2) the step against the damped normal equations -------------------------


@pytest.mark.parametrize("factor", [1.0, 1e2])
@pytest.mark.parametrize("mode", schur.MODES)
def test_float64_step_within_the_bounds(generated, mode, factor):
    """Every mode's float64 damped step (``schur.solve_damped``) at the
    generated problem's start, at the rule's first lambda and 100x it:
    eta within the float64 bound."""
    ctx, _, lam0 = lm._prepare(generated.state, generated, mode)
    lam = float(lam0) * factor
    dxp, dxc = schur.solve_damped(ctx, lam, generated, mode)
    res = bench.step_residual(generated, bench.run_blocks(generated, generated.state, "f64"),
                              dxp, dxc, lam)
    print(f"{mode} lambda {lam:.3g}: eta {res['eta']:.3g}")
    assert res["eta"] <= F64["eta"]


def _df32_step(problem, factor: float):
    """(the state, lambda, the df32 plain-chain step) at the start."""
    fast = pm.to_fast(problem.state)
    ctx, _, lam0 = lm._prepare_fast(fast, problem, "cholesky", "float32", kernels=False)
    lam = float(np.float32(float(lam0) * factor))
    dxp, dxc = schur.solve_damped(ctx, lam, problem, "cholesky", mm_dtype=torch.float32)
    return pm.from_fast(fast, dtype=torch.float64), lam, dxp.double(), dxc.double()


@pytest.mark.parametrize("factor", [1.0, 1e2])
def test_df32_step_within_the_bounds(generated, factor):
    """The df32 step of the plain chain (float32 Schur, float32 lambda) at
    the generated problem's start: eta against the run's own chain within
    the df32 bound."""
    state, lam, dxp, dxc = _df32_step(generated, factor)
    res = bench.step_residual(generated, bench.run_blocks(generated, state, "df32"),
                              dxp, dxc, lam)
    print(f"df32 lambda {lam:.3g}: eta {res['eta']:.3g}")
    assert res["eta"] <= DF32["eta"]


@pytest.mark.parametrize("geometry", ["f64", "df32"])
def test_scaled_step(generated, geometry):
    """The step at the generated problem's start scaled by 1 + 1e-3 in
    float64 (at the rule's lambda) and by 1 + ``STEP_FAULT_DF32`` at df32
    (at 1e3 x the rule's lambda) reads at least 10x its geometry's bound
    on eta. At df32 and the rule's lambda the float32 step sends a point
    seen at a narrow angle off by ~1e9 units, and that step's length
    dominates eta's denominator: a scaled step there reads as the clean
    one (printed); a 1 + 1e-3 scaling stays under the df32 bound."""
    if geometry == "f64":
        ctx, _, lam0 = lm._prepare(generated.state, generated, "cholesky")
        lam = float(lam0)
        dxp, dxc = schur.solve_damped(ctx, lam, generated, "cholesky")
        state, size, bound = generated.state, 1e-3, F64["eta"]
    else:
        state, lam, dxp, dxc = _df32_step(generated, 1e3)
        size, bound = bench.STEP_FAULT_DF32, DF32["eta"]
        _, lam0, dxp0, dxc0 = _df32_step(generated, 1.0)
        at_rule = bench.step_residual(generated, bench.run_blocks(generated, state, geometry),
                                      dxp0 * (1 + size), dxc0 * (1 + size), lam0)["eta"]
        print(f"df32 at the rule's lambda, scaled by 1 + {size:g}: eta {at_rule:.3g}")
    blocks = bench.run_blocks(generated, state, geometry)
    clean = bench.step_residual(generated, blocks, dxp, dxc, lam)["eta"]
    read = {s: bench.step_residual(generated, blocks, dxp * (1 + s), dxc * (1 + s),
                                   lam)["eta"] for s in sorted({1e-3, size})}
    print(f"{geometry} step scaled: clean eta {clean:.3g}, scaled "
          + ", ".join(f"by 1 + {s:g} {v:.3g}" for s, v in read.items()))
    assert clean <= bound and read[size] >= 10 * bound


def test_df32_step_as_good_as_jax(monkeypatch):
    """The port's and the JAX package's df32 steps (float32 Schur, the plain
    chain, ``jlm._prepare_fast(..., pallas=False)``) at the same states:
    numpy-made synthetic problems (6 x 40, tau 2 px, seeds 0-3) at 1, 2 and
    8 times the first lambda, where the float32 Cholesky breaks down and
    the refined LU fallback runs (``test_torch_schur.py::
    test_float32_step_as_accurate_as_jax``). Both steps' eta against the
    port's df32 chain lie under the df32 bound, and the port's largest is
    within 2x of JAX's largest."""
    etas = {"jax": [], "port": []}
    for seed in range(4):
        jp = make_synthetic_problem(n_cameras=6, n_points=40, obs_per_point=4,
                                    seed=seed, inlier_threshold=2.0, dtype=jnp.float64)
        tp = convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")
        ctx_j, _, lam0 = jlm._prepare_fast(jpm.to_fast(jp.state), jp, "cholesky",
                                           "float32", pallas=False)
        fast = pm.to_fast(tp.state)
        ctx_t, _, _ = lm._prepare_fast(fast, tp, "cholesky", "float32", kernels=False)
        state = pm.from_fast(fast, dtype=torch.float64)
        blocks = bench.run_blocks(tp, state, "df32")
        for factor in (1.0, 2.0, 8.0):
            lam32 = float(np.float32(float(lam0) * factor))
            steps = {
                "jax": jschur.solve_damped(ctx_j, jnp.float32(lam32), jp, "cholesky",
                                           mm_dtype=jnp.float32),
                "port": schur.solve_damped(ctx_t, lam32, tp, "cholesky",
                                           mm_dtype=torch.float32)}
            for which, (dxp, dxc) in steps.items():
                dxp, dxc = (torch.from_numpy(np.asarray(x, dtype=np.float64))
                            for x in (dxp, dxc))
                etas[which].append(bench.step_residual(tp, blocks, dxp, dxc, lam32)["eta"])
    top = {k: max(v) for k, v in etas.items()}
    print(f"df32 step eta, 12 cases: JAX max {top['jax']:.3g} median "
          f"{np.median(etas['jax']):.3g}; port max {top['port']:.3g} median "
          f"{np.median(etas['port']):.3g}")
    assert top["jax"] <= DF32["eta"] and top["port"] <= DF32["eta"]
    assert top["port"] <= 2.0 * top["jax"]


# -- the observer ----------------------------------------------------------------


def test_jit_states_equal_host_states(generated):
    """Both drives hand over one state per iteration, equal bit for bit,
    with their records; the jit run reads once per iteration, and its
    flatline stop's last state is the one before (its step discarded),
    which the gate does not check."""
    cfg = lm.LMConfig(max_iter=200)
    host = observed(generated, cfg, "host")
    jit = observed(generated, cfg, "jit")
    assert lm.LAST_JIT_RUN["reads"] == lm.LAST_JIT_RUN["replays"] == jit[0].iterations
    assert jit[0].status == host[0].status == lm.LMStatus.Success
    assert [s[0] for s in jit[2]] == [s[0] for s in host[2]] == list(
        range(1, jit[0].iterations + 1))
    for (_, a, ra), (_, b, rb) in zip(jit[2], host[2]):
        assert ra == rb
        assert all(torch.equal(x, y) for x, y in zip(lm._leaves(a), lm._leaves(b)))
    last, before = host[2][-1][1], host[2][-2][1]
    assert all(torch.equal(x, y) for x, y in zip(lm._leaves(last), lm._leaves(before)))
    check = gate(generated, cfg, *host[::2])
    print(f"generated 12 x 300, float64 cholesky to the flatline: {check}")
    assert check["ok"] and check["discarded"] == 1
    assert check["checked"] == sum(r.accepted for r in host[1]) - 1


# -- numerics_gate on runs -------------------------------------------------------


@pytest.fixture(scope="module")
def p16():
    return pm.load_bal_problem(os.path.join(ROOT, campaign.PROBLEMS["p16"]), device="cpu")


FAULTS = bench.planted_faults()
P16_CFG = dataclasses.replace(campaign.drive_config("f64", 20), drive="host")


@pytest.mark.parametrize("fault", [None, "step-scaled"])
def test_gate_on_p16_float64(p16, fault):
    """p16 float64 cholesky, 20 iterations on the host drive: clean, every
    accepted step and energy passes; with the reduced right-hand side
    scaled by 1 + STEP_FAULT, gate (e) fails on eta at the first
    iteration, 10x past its bound, while gate (d3) passes the same run."""
    with bench.planted(FAULTS[fault]) if fault else contextlib.nullcontext():
        res, records, states = observed(p16, P16_CFG)
    check = gate(p16, P16_CFG, res, states)
    endpoint = {"status": STATUS[res.status], "iterations": res.iterations,
                "fun_evals": res.fun_evals, "energy": res.energy, "lam": res.lam}
    control = bench.control_gate(records, P16_CFG, endpoint)
    print(f"p16 f64 cholesky, fault {fault}: checked {check['checked']}, over "
          f"{check['over']}, eta {check['eta']}, energy gap {check['energy_gap']}, "
          f"allowance {check['allowance']}, loose {check['loose']}, {check['seconds']:.3g} s")
    assert control["ok"] and check["checked"] == 20
    if fault is None:
        assert check["ok"] and check["energy_gap"]["max"] <= F64["energy_gap"]
    else:
        assert not check["ok"] and check["over"]["what"] == "eta"
        assert check["over"]["iteration"] == 1
        assert check["over"]["value"] >= 10 * F64["eta"]


def test_energy_fault_fails_only_the_energy_check(generated):
    """df32 on the generated problem (plain chain, 30 iterations): clean,
    gate (e) passes; with both chain entry points' energies scaled by
    1 + ENERGY_FAULT, (e3) fails at the first accept, at least 10x past
    its bound, while (d3) and (e2) pass."""
    cfg = dataclasses.replace(campaign.drive_config("df32", 30), drive="host")
    clean = gate(generated, cfg, *observed(generated, cfg)[::2])
    with bench.planted(FAULTS["energy-scaled"]):
        res, records, states = observed(generated, cfg)
    check = gate(generated, cfg, res, states)
    endpoint = {"status": STATUS[res.status], "iterations": res.iterations,
                "fun_evals": res.fun_evals, "energy": res.energy, "lam": res.lam}
    print(f"df32 energies: clean gap {clean['energy_gap']}, faulty {check['energy_gap']}")
    assert clean["ok"], clean["over"]
    assert bench.control_gate(records, cfg, endpoint)["ok"]
    assert check["over"]["what"] == "energy_gap" and check["over"]["iteration"] == 1
    assert check["energy_gap"]["max"] >= 10 * DF32["energy_gap"]
    assert check["eta"]["max"] <= DF32["eta"]


def test_checker_runs_none_of_the_solve(monkeypatch, generated):
    """With ``schur.solve_damped``, ``schur.build_context`` and the camera
    update ``models.problem._camera_step`` raising, the checker still
    passes a clean run's states and fails them with one state moved; its
    source names none of them."""
    cfg = dataclasses.replace(lm.LMConfig(max_iter=15), drive="host")
    res, _, states = observed(generated, cfg)

    def boom(*a, **kw):
        raise AssertionError("the checker ran the solve")

    for module, name in ((schur, "solve_damped"), (schur, "build_context"),
                         (pm, "_camera_step")):
        monkeypatch.setattr(module, name, boom)
    assert gate(generated, cfg, res, states)["ok"]
    it, state, record = states[4]
    moved = dataclasses.replace(state, points=state.points * (1 + 1e-6))
    broken = gate(generated, cfg, res, states[:4] + [(it, moved, record)] + states[5:])
    assert broken["over"]["iteration"] == 5 and not broken["ok"]
    source = "".join(inspect.getsource(f) for f in (
        bench.numerics_gate, bench.step_residual, bench.recover_step,
        bench.run_blocks, bench._trial_lambda))
    assert not any(name in source for name in ("solve_damped", "build_context",
                                               "_camera_step", "schur."))


def test_a_gate_that_cannot_run_fails(generated):
    """A run without states, or a state that does not fit the problem,
    fails the gate with its reason, and nothing is skipped."""
    cfg = lm.LMConfig(max_iter=3)
    none = bench.numerics_gate(generated, generated.state, [], cfg, "x")
    assert not none["ok"] and none["error"] == "no accepted iteration to check"
    res, _, states = observed(generated, cfg)
    it, state, record = states[0]
    short = dataclasses.replace(state, points=state.points[:-1])
    bad = bench.numerics_gate(generated, generated.state, [(it, short, record)],
                              cfg, STATUS[res.status])
    assert not bad["ok"] and bad["error"]

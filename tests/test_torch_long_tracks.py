"""The port on long tracks against the benchmark's float64 reference
(``portbench/reference/ba.py``), on the CPU.

BAL's Final problems see each point from many cameras, so the reduced
camera system is summed from many observation pairs: sum d (d - 1) / 2
over the points, a point of degree d. A small problem from the frozen
generator (``portbench/core/balgen.py``: 48 cameras, 2,000 points, mean
degree 7.4, 4.4 pairs an observation against p257's 2.0) runs the port's
pair gram (``schur._pair_gram_tables``) in cholesky and in qrkit's
re-damp, on the float64 drive and on the df32 drive, against the
reference's damped step and LM iterations. The benchmark's Final-961 cell
is held here too: it resolves, and its configuration's observation count
is the frozen generator's. This file imports nothing of JAX.
"""

import os
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu_torch.io.bal import BalDataset
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import balgen, check, registry, session  # noqa: E402
from portbench.reference import ba  # noqa: E402

MODES = ("cholesky", "qrkit")
DRIVES = {"f64": {}, "df32": dict(geometry="df32", matmul_dtype="float32")}
#: Multiples of the mode's first-iteration lambda at which the steps are
#: compared: near the LM's working range, and heavily damped.
LAM_FACTORS = (1e2, 1e6)
#: The Final-961 stand-in's cell.
CELLS = ("final961-df32-cholesky",)


@pytest.fixture(scope="module")
def long_tracks():
    raw = balgen.generate_bal_like(48, 2000, seed=5, mean_degree=8.6)
    prob = pm.from_bal_dataset(BalDataset(**raw), inlier_threshold=0.5,
                               device="cpu")
    ref_prob, ref_state = ba.from_raw(raw, 0.5, "cpu")
    return raw, prob, ref_prob, ref_state


def test_the_problem_has_long_tracks(long_tracks):
    raw, prob, _, _ = long_tracks
    d = np.bincount(raw["pt_idx"])
    pairs = int((d * (d - 1) // 2).sum())
    assert d.mean() > 7 and pairs > 4 * d.sum()
    # The port's pair tables hold every pair once (sentinel K elsewhere).
    assert int((prob.pairs.row_a < prob.n_observations).sum()) == pairs


def _step(prob, mode, drive, lam):
    """The port's damped step from the problem's state at ``lam`` (float32
    lambda on the df32 drive, as its trial rounds it), float64, and that
    lambda."""
    if drive == "f64":
        ctx = lm._prepare(prob.state, prob, mode)[0]
        dxp, dxc = schur.solve_damped(ctx, lam, prob, mode)
    else:
        lam = float(torch.tensor(lam, dtype=torch.float32))
        ctx = lm._prepare_fast(pm.to_fast(prob.state), prob, mode,
                               matmul_dtype="float32")[0]
        dxp, dxc = schur.solve_damped(ctx, lam, prob, mode,
                                      mm_dtype=torch.float32)
    return dxp.double(), dxc.double(), lam


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("factor", LAM_FACTORS)
@pytest.mark.parametrize("drive", sorted(DRIVES))
@pytest.mark.parametrize("mode", MODES)
def test_damped_step_matches_the_reference(long_tracks, mode, drive, factor):
    """The port's ``solve_damped`` against the reference's ``damped_step``
    at the same state and lambda: the step's Jacobi-scaled backward error
    in the reference's damped normal equations, and what the step leaves
    of the energy against the reference's step, over the reference's
    decrease."""
    _, prob, ref_prob, s = long_tracks
    ne = ba.normal(s, ref_prob)
    dxp, dxc, lam = _step(prob, mode, drive,
                          factor * ba.initial_lambda(ne, mode))
    dX, dc = ba.damped_step(ne, lam, ref_prob)
    e0 = ba.energy(s, ref_prob)
    e_ref = ba.energy(ba.apply_step(s, dX, dc), ref_prob)
    loss = (ba.energy(ba.apply_step(s, dxp, dxc), ref_prob) - e_ref) / (e0 - e_ref)
    error = ba.backward_error(s, ref_prob, lam, dxp, dxc)
    gap = max(_rel(dxp, dX), _rel(dxc, dc))
    print(f"{mode} {drive} x{factor:g}: backward error {error:.3g}, "
          f"loss {loss:.3g}, step gap {gap:.3g}")
    if drive == "f64":
        # Both solve one float64 system: backward errors read 2-3e-15. The
        # Jacobi-scaled system's condition at 1e2 x the first lambda is
        # ~1e8, so steps agree to ~1e-8 there (4.5e-8 read) and to 2e-12
        # at 1e6 x.
        assert error < 1e-12
        assert gap < 1e-6
        assert abs(loss) < 1e-8
    else:
        # float32 pair gram and camera solve: backward errors read
        # 1.7e-6 to 4.3e-6, where the reference's exact step made 1% too
        # long reads 1.3e-5 to 4.3e-5; the energy the step leaves is
        # within 1.6e-4 of the reference's decrease (the cells hold the
        # median over three iterations to 0.1).
        assert error < 1e-5
        assert abs(loss) < 1e-2


STOPS = {"Success": "flatlined", "ExceededLambdaMax": "lambda_max",
         "MaxItersReached": "max_iters"}


@pytest.mark.parametrize("drive", sorted(DRIVES))
@pytest.mark.parametrize("mode", MODES)
def test_lm_iterations_match_the_reference(long_tracks, mode, drive):
    """``lm.minimize`` with ``max_iter`` 1, 2, 3 from the problem's state,
    each iteration against the reference's ``lm_iteration`` from the
    port's state and lambda before it, read as the benchmark reads a
    cell's followed solve (``portbench/core/check.follow``)."""
    _, prob, ref_prob, s = long_tracks
    steps = [check.Step(0, s, None, None, 0, None)]
    for k in (1, 2, 3):
        r = lm.minimize(prob, mode, lm.LMConfig(max_iter=k, **DRIVES[drive]),
                        device="cpu")
        steps.append(check.Step(k, session.ref_state(r.state), float(r.energy),
                                float(r.lam), r.fun_evals,
                                STOPS[lm.LMStatus(r.status).name]))
    notes, iterations = [], []
    got = check.follow(ref_prob, steps, mode, notes, iterations)
    print(mode, drive, {k: f"{v:.3g}" for k, v in got.items()}, notes)
    assert len(iterations) == 3
    assert all(it["program"] < it["before"] for it in iterations)
    if drive == "f64":
        # The float64 cell's limits (PERF.md section 2); read here: energy
        # gaps <= 1e-14, lambda 1e-12, backward errors 1.1e-13. The same
        # trials, and the step's energy within 1e-4 of the reference's
        # first decrease (5.8e-6 read: at cholesky's first lambda the
        # system's condition is ~1e12, and the two solves part along the
        # gauge).
        assert not notes
        assert got["iter_energy_gap"] < 1e-11
        assert got["lam_gap"] < 1e-6
        assert got["step_error"] < 1e-8
        assert got["step_loss"] < 1e-4
    else:
        # The df32 cells' limits: the claimed energy (the chain's float32
        # residuals; 1.2e-5 read) within 1e-3, and the step's loss 0.1
        # (1.6e-3 read). lambda is not held: df32's rho moves it by up to 5x.
        # The backward error reads 1.3e-6 to 5.9e-6 (section above).
        assert got["iter_energy_gap"] < 1e-3
        assert got["step_loss"] < 0.1
        assert got["step_error"] < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_the_new_cells_resolve(name):
    bench = registry.load_benchmark()
    cell = registry.cell(bench, name)
    assert cell.chips == 1
    assert cell.traffic == {"mode": name.rsplit("-", 1)[1], "geometry": "df32",
                            "max_iter": 100}
    assert {"end_energy_gap", "end_gain", "iter_energy_gap", "step_loss",
            "window_captures"} <= set(cell.spec["limits"])
    layers = {e["name"] for e, _ in registry.metrics(bench, name, True)}
    assert {"pair_gram_ms", "pair_gram_roofline_pct", "trial_ms"} <= layers


@pytest.mark.parametrize("name", [w["name"] for w in
                                  registry.load_benchmark()["workloads"]])
def test_every_cell_reads_the_pair_gram(name):
    """Every cell's problem has pair tables, so a traced run reads both
    pair-gram metrics there."""
    layers = {e["name"] for e, _ in
              registry.metrics(registry.load_benchmark(), name, True)}
    assert {"pair_gram_ms", "pair_gram_roofline_pct"} <= layers


def test_final_961_configuration_is_the_generators():
    """The stand-in's stated observation count is what the frozen generator
    gives at its seed (~4 s), at BAL Final-961's cameras and points."""
    bench = registry.load_benchmark()
    conf = registry.cell(bench, "final961-df32-cholesky").config
    entry = next(c for c in bench["configs"] if c["name"] == conf["name"])
    assert entry["source"] == conf["source"]
    assert (conf["n_cameras"], conf["n_points"]) == (961, 187103)
    assert conf["data"]["mean_degree"] == 1692975 / 187103
    raw = session.raw_arrays(conf)
    assert len(raw["pt_idx"]) == conf["n_observations"] == 1609829
    d = np.bincount(raw["pt_idx"], minlength=conf["n_points"])
    assert d.max() == 20
    assert int((d * (d - 1) // 2).sum()) == 8250759

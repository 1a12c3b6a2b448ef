"""Flatline parity of the PyTorch port on the H100: the rows of
``torch_results/flatline_h100.json`` (``flatline_campaign.py``, every mode
on the f64, df32 and df32p drives at p16, p126 and p257, and cholesky on
the Ladybug stand-in, each run to the reference's energy-flatline stop,
BacktrackLevMarqCholesky.h:343-350) held to the JAX campaign's checks
(tests/test_flatline_parity.py), unchanged:

* ``BUDGETS``, a copy of JAX's (one test asserts that they are equal);
* the p16 rows of every drive and mode against the independent scipy port's
  flatline (``benchmarks/results/cpu_p16_flatline.json``), with the
  dominance clause;
* mutual parity of the five modes at p126 and p257 on f64 and df32;
* each f64 row against the JAX campaign's f64 row of the same problem and
  mode (``benchmarks/parity_campaign.json``), the same comparison at the
  f64 budget (statistics, not times);
* the rows of the device-resident LM drive (``lm_drive: "jit"``, p257
  under every mode on f64 and df32) to the same checks: recorded on the
  card, mutual parity, and each f64 row against JAX's.

A missing row skips; a CRASHED or TIMEOUT row fails. The file reads JSON
and runs on the CPU; two tests run code: the trajectory anchor (the JAX
package's first iterations on p16 against the card's trace) and the
campaign's row function on a small synthetic problem.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

import test_flatline_parity as jax_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import flatline_campaign as campaign  # noqa: E402

ARTIFACT = os.path.join(ROOT, campaign.ARTIFACT)
JAX_CAMPAIGN = os.path.join(ROOT, "benchmarks", "parity_campaign.json")
P16 = "problem-16-22106-pre.txt.gz"
ORACLE = {P16: os.path.join(ROOT, "benchmarks", "results", "cpu_p16_flatline.json")}
MUTUAL_PROBLEMS = ("problem-126-40037-pre.txt.gz", "problem-257-65132-pre.txt.gz")
PROBLEMS = (P16,) + MUTUAL_PROBLEMS
MODES = campaign.MODES
DRIVES = campaign.DRIVES

#: The JAX campaign's budgets (flatline_campaign.BUDGETS, a copy of
#: tests/test_flatline_parity.py:54-86; test_budgets_equal_jax holds it).
BUDGETS = campaign.BUDGETS


def _load(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _rows(path, lm_drive="host"):
    """(problem, mode, drive) -> row of the artifact, for one LM drive."""
    data = _load(path)
    if data is None:
        return {}
    return {(r["problem"], r["mode"], r["drive"]): r for r in data["rows"]
            if r.get("lm_drive", "host") == lm_drive}


PORT_ROWS = _rows(ARTIFACT)
JIT_ROWS = _rows(ARTIFACT, "jit")
JAX_ROWS = _rows(JAX_CAMPAIGN)
#: The jit drive's rows: p257, every mode, f64 and df32.
JIT_PROBLEM, JIT_DRIVES = "problem-257-65132-pre.txt.gz", ("f64", "df32")


def port_row(problem, mode, drive, rows=None):
    rows = PORT_ROWS if rows is None else rows
    row = rows.get((problem, mode, drive))
    if row is None:
        pytest.skip(f"port row ({problem}, {mode}, {drive}) not recorded")
    assert row["status"] not in ("CRASHED", "TIMEOUT"), row
    return row


def assert_within_budget(post, ref, budget, where):
    """``flatline_campaign.budget_gaps`` (tests/test_flatline_parity.py:
    151-198): a row that improves both continuous statistics on ``ref`` is
    held only to an inlier-count deficit; any other to every budget."""
    verdict = campaign.budget_gaps(post, ref, budget)
    assert verdict["within"], (
        f"{where}: gaps {verdict['gaps']} (dominates: {verdict['dominates']}) "
        f"against budget {budget}; inlier mean err "
        f"{post['inlier_mean_reprojection_error']:.6f} vs "
        f"{ref['inlier_mean_reprojection_error']:.6f}, objective "
        f"{post['true_objective']:.4f} vs {ref['true_objective']:.4f}, "
        f"{post['n_inliers']} vs {ref['n_inliers']} inliers")


def test_budgets_equal_jax():
    assert BUDGETS == jax_parity.BUDGETS


@pytest.mark.parametrize("case,post,want", [
    ("inside", dict(px=0.0728, obj=2150.0, n=59000), True),
    ("px outside", dict(px=0.0740, obj=2150.0, n=59903), False),
    ("objective outside", dict(px=0.0729, obj=2200.0, n=59903), False),
    ("count outside", dict(px=0.0729, obj=2150.0, n=57000), False),
    ("dominates, more inliers", dict(px=0.0700, obj=2000.0, n=64000), True),
    ("dominates, count deficit", dict(px=0.0700, obj=2000.0, n=57000), False),
])
def test_budget_gaps_cases(case, post, want):
    """The comparison on hand-made statistics around the p16 oracle's
    (0.072808 px, objective 2147.76, 59,903 inliers) at the f64 budget,
    the dominance clause included."""
    ref = {"inlier_mean_reprojection_error": 0.072808, "true_objective": 2147.76,
           "n_inliers": 59903}
    row = {"inlier_mean_reprojection_error": post["px"],
           "true_objective": post["obj"], "n_inliers": post["n"]}
    assert campaign.budget_gaps(row, ref, BUDGETS["f64"])["within"] is want, case


def test_artifact_header_names_the_card():
    data = _load(ARTIFACT)
    if data is None:
        pytest.skip("torch_results/flatline_h100.json not recorded")
    header = data["header"]
    assert "H100" in header["card"] and header["card"].endswith(" W"), header
    assert "H100" in header["kind"] and header["commit"]
    for row in data["rows"]:
        assert row["card"] == header["card"], row["problem"]


@pytest.mark.parametrize("problem,mode,drive", campaign.plan(
    ["p16", "p126", "p257", "ladybug"], MODES, DRIVES))
def test_row_recorded_on_the_card(problem, mode, drive):
    """Every planned row is on the card, ran to an LM stop with finite
    statistics, accepted a strictly falling energy in each phase, and
    launched the chain kernels exactly on the df32 drives."""
    name = campaign.LADYBUG_NAME if problem == "ladybug" else os.path.basename(
        campaign.PROBLEMS[problem])
    check_row_on_card(port_row(name, mode, drive), drive)


@pytest.mark.parametrize("drive", JIT_DRIVES)
@pytest.mark.parametrize("mode", MODES)
def test_jit_row_recorded_on_the_card(mode, drive):
    """The jit drive's p257 rows pass the checks of every row."""
    row = port_row(JIT_PROBLEM, mode, drive, JIT_ROWS)
    assert row["lm_drive"] == "jit"
    check_row_on_card(row, drive)
    check_jit_reads(row)


def check_row_on_card(row, drive):
    assert row["platform"] == "gpu"
    assert row["status"] in ("Success (Energy Flatlined)",
                             "Success (Exceeded Maximum Lambda)"), row["status"]
    assert 0 < row["iterations"] < 2000 and row["fun_evals"] > row["iterations"]
    assert math.isclose(row["it_per_s"], row["iterations"] / row["wall_s"])
    assert row["peak_bytes"] > 0
    post = row["post"]
    assert all(math.isfinite(post[k]) for k in post)
    assert 0 < post["n_inliers"] <= post["n_observations"]
    for phase in ("fast", "polish", None):
        energies = [t["energy"] for t in row["trace"] if t.get("phase") == phase]
        assert all(b < a for a, b in zip(energies, energies[1:])), phase
    assert row["trace"], "no accepted iteration"
    df32 = drive in ("df32", "df32p")
    assert (row["launches"]["chain_blocks"] > 0) == df32
    assert (row["launches"]["chain_energy"] > 0) == df32


@pytest.mark.parametrize("drive", DRIVES)
@pytest.mark.parametrize("mode", MODES)
def test_p16_against_oracle(mode, drive):
    """The p16 rows against the scipy port's flatline (the JAX campaign's
    test_flatline_statistics_parity)."""
    oracle = _load(ORACLE[P16])
    row = port_row(P16, mode, drive)
    assert_within_budget(row["post"], oracle["post"], BUDGETS[drive],
                         f"{mode}/{drive}/{P16} vs scipy")


@pytest.mark.parametrize("drive", ["f64", "df32"])
@pytest.mark.parametrize("problem", MUTUAL_PROBLEMS)
def test_large_scale_mutual_parity(problem, drive):
    """All five modes recorded and within budget of the cholesky row (the
    JAX campaign's test_large_scale_mutual_parity)."""
    check_mutual_parity(problem, drive, PORT_ROWS)


@pytest.mark.parametrize("drive", JIT_DRIVES)
def test_jit_large_scale_mutual_parity(drive):
    """The jit drive's p257 rows: mutual parity, as the host drive's."""
    check_mutual_parity(JIT_PROBLEM, drive, JIT_ROWS)


def check_mutual_parity(problem, drive, table):
    rows = {m: port_row(problem, m, drive, table) for m in MODES}
    budget, anchor = BUDGETS[drive], rows["cholesky"]["post"]
    for m, row in rows.items():
        post = row["post"]
        d_px = abs(post["inlier_mean_reprojection_error"]
                   - anchor["inlier_mean_reprojection_error"])
        assert d_px < budget["inlier_px"], (problem, drive, m, d_px)
        rel_obj = abs(post["true_objective"] - anchor["true_objective"]) \
            / anchor["true_objective"]
        assert rel_obj < budget["obj_rtol"], (problem, drive, m, rel_obj)
        rel_cnt = abs(post["n_inliers"] - anchor["n_inliers"]) / anchor["n_inliers"]
        assert rel_cnt < budget["inlier_count_rtol"], (problem, drive, m, rel_cnt)


#: JAX f64 rows that lie outside the f64 budget of the scipy oracle's p16
#: flatline, two-sided: p16 qrkit (0.070775 px, objective 2040.90, 63,890
#: inliers against 0.072808, 2147.76, 59,903: 2.0e-3 px, 5.0%, +6.7%) sits
#: in a deeper basin of the plateau and passes JAX's own test only by the
#: dominance clause. It is no reference at the f64 budget; the port's row
#: of it is held to the oracle instead (test_f64_against_jax_row). The
#: port's qrkit takes JAX's steps (p16 iterations 1-6 within 5.1e-9 of
#: JAX's on the CPU) and parts at iteration 7 (6.6e-6), as every float64
#: implementation parts on this plateau (see ANCHOR_RTOL).
JAX_OFF_ORACLE = {(P16, "qrkit")}


def off_budget(post, ref, budget) -> bool:
    """Whether ``post`` lies outside ``budget`` of ``ref`` on any statistic,
    both ways (no dominance clause)."""
    return (abs(post["inlier_mean_reprojection_error"]
                - ref["inlier_mean_reprojection_error"]) >= budget["inlier_px"]
            or abs(post["true_objective"] - ref["true_objective"])
            / ref["true_objective"] >= budget["obj_rtol"]
            or abs(post["n_inliers"] - ref["n_inliers"])
            / ref["n_inliers"] >= budget["inlier_count_rtol"])


def test_jax_rows_off_the_oracle():
    """The JAX f64 p16 rows outside the f64 budget of the oracle are
    exactly JAX_OFF_ORACLE."""
    oracle = _load(ORACLE[P16])["post"]
    off = {(P16, m) for m in MODES
           if off_budget(JAX_ROWS[(P16, m, "f64")]["post"], oracle, BUDGETS["f64"])}
    assert off == JAX_OFF_ORACLE


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("problem", PROBLEMS)
def test_f64_against_jax_row(problem, mode):
    """Each f64 row against the JAX campaign's f64 row of the same problem
    and mode, at the f64 budget; where JAX's row is off the oracle
    (JAX_OFF_ORACLE), against the oracle at the same budget."""
    check_f64_against_jax(problem, mode, PORT_ROWS)


@pytest.mark.parametrize("mode", MODES)
def test_jit_f64_against_jax_row(mode):
    """The jit drive's p257 f64 rows against JAX's, as the host drive's."""
    check_f64_against_jax(JIT_PROBLEM, mode, JIT_ROWS)


def check_f64_against_jax(problem, mode, table):
    ref = JAX_ROWS.get((problem, mode, "f64"))
    if ref is None:
        pytest.skip(f"JAX row ({problem}, {mode}, f64) not recorded")
    row = port_row(problem, mode, "f64", table)
    if (problem, mode) in JAX_OFF_ORACLE:
        assert_within_budget(row["post"], _load(ORACLE[problem])["post"],
                             BUDGETS["f64"], f"{mode}/f64/{problem} vs scipy")
        return
    assert_within_budget(row["post"], ref["post"], BUDGETS["f64"],
                         f"{mode}/f64/{problem} vs JAX")


# -- the trajectory anchor ----------------------------------------------------------

#: The first iterations of the card's p16 f64 cholesky row against the JAX
#: package on the CPU (x64, jit drive, the energy after max_iter = k for
#: k = 1..ANCHOR_ITERS). Measured relative gaps of the committed row
#: (H100): iterations 1-5 2.9e-10, 6.6e-9, 7.1e-9, 4.5e-8, 2.1e-8; then
#: 2.0e-6, 1.3e-6, 5.2e-6 and, at 9, 1.2e-3, where the two accept steps of
#: another rho (lambda 1.7e-5 against JAX's 7.5e-5). The port on the CPU
#: parts from JAX at iteration 7 (3.8e-4), and the scipy oracle from both
#: at iteration 4 (1e-5): cholesky's first lambda is 1e-12 of the largest
#: diagonal entry, so rounding in the near-singular early steps moves the
#: robust plateau's accept decisions. The anchor holds the 5 iterations
#: that every float64 implementation shares.
ANCHOR_ITERS = 5
ANCHOR_RTOL = 1e-6


@pytest.fixture(scope="module")
def jax_p16_energies():
    from bundleadjustment_benchmarks_tpu.models.problem import load_bal_problem
    from bundleadjustment_benchmarks_tpu.solvers import lm as jlm

    prob = load_bal_problem(os.path.join(ROOT, "data", P16))
    out = []
    for k in range(1, ANCHOR_ITERS + 1):
        res = jlm.minimize(prob, "cholesky", jlm.LMConfig(drive="jit", max_iter=k))
        out.append((float(res.energy), float(res.lam)))
    return out


def test_trajectory_anchor(jax_p16_energies):
    row = port_row(P16, "cholesky", "f64")
    trace = row["trace"][:ANCHOR_ITERS]
    assert [t["iter"] for t in trace] == list(range(1, ANCHOR_ITERS + 1))
    gaps = [abs(t["energy"] - e) / e for t, (e, _) in zip(trace, jax_p16_energies)]
    print("energy gaps to JAX by iteration:", gaps)
    assert max(gaps) <= ANCHOR_RTOL, gaps


# -- the campaign's row function on the CPU -----------------------------------------


@pytest.fixture(scope="module")
def tiny_bal(tmp_path_factory):
    from test_torch_cli import write_synthetic_bal

    return write_synthetic_bal(str(tmp_path_factory.mktemp("bal") / "tiny.txt"))


@pytest.mark.parametrize("drive", DRIVES)
def test_row_function_on_cpu(tiny_bal, drive):
    """``flatline_campaign.run_row`` on a small synthetic problem on the
    CPU: the JAX campaign's row keys plus the port's, and ``post`` equal to
    the JAX package's utils/stats on the same end state to 1e-12."""
    import jax.numpy as jnp

    from bundleadjustment_benchmarks_tpu.models.problem import BAState
    from bundleadjustment_benchmarks_tpu.models.problem import (
        load_bal_problem as jload)
    from bundleadjustment_benchmarks_tpu.utils import stats as jstats

    problem, name = campaign.load_problem(tiny_bal, "cpu")
    row, state = campaign.run_row(problem, name, "cholesky", drive, max_iter=30,
                                  device="cpu")
    assert set(row) == {"problem", "mode", "drive", "lm_drive", "platform",
                        "status", "iterations", "fun_evals", "energy", "wall_s",
                        "post", "it_per_s", "peak_bytes", "launches", "trace",
                        "jit"}
    assert (row["problem"], row["mode"], row["drive"], row["lm_drive"],
            row["platform"]) == ("tiny.txt", "cholesky", drive, "host", "cpu")
    assert row["peak_bytes"] is None and row["jit"] is None
    assert row["launches"] == {"chain_blocks": 0, "chain_energy": 0,
                               "chain_blocks_f64": 0, "chain_energy_f64": 0}
    assert row["trace"] and set(row["trace"][0]) >= {"iter", "energy", "lam"}
    assert json.loads(json.dumps(row)) == row
    jp = jload(tiny_bal)
    js = BAState(**{k: jnp.asarray(getattr(state, k).numpy())
                    for k in ("K", "R", "T", "k1", "k2", "points")})
    st = jstats.error_statistics(js, jp.obs, campaign.FOCAL, campaign.TAU)
    ref = {"mean_reprojection_error": float(st.mean_reprojection_error),
           "inlier_mean_reprojection_error": float(st.inlier_mean_reprojection_error),
           "n_inliers": int(st.n_inliers), "n_observations": int(st.n_observations),
           "true_objective": float(jstats.true_objective(
               js, jp.obs, campaign.FOCAL, campaign.TAU))}
    assert row["post"]["n_inliers"] == ref["n_inliers"]
    assert row["post"]["n_observations"] == ref["n_observations"]
    for k in ("mean_reprojection_error", "inlier_mean_reprojection_error",
              "true_objective"):
        np.testing.assert_allclose(row["post"][k], ref[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("drive", ["f64", "df32"])
def test_row_function_jit_on_cpu(tiny_bal, drive):
    """``run_row`` with ``lm_drive="jit"``: the host drive's row, the same
    LM path and statistics (the two drives do the same arithmetic)."""
    problem, name = campaign.load_problem(tiny_bal, "cpu")
    rows = {d: campaign.run_row(problem, name, "cholesky", drive, max_iter=30,
                                device="cpu", lm_drive=d)[0]
            for d in ("host", "jit")}
    assert rows["jit"]["lm_drive"] == "jit"
    for k in ("status", "iterations", "fun_evals", "energy", "post", "trace"):
        assert rows["jit"][k] == rows["host"][k], k
    check_jit_reads(rows["jit"])


def check_jit_reads(row):
    """One host read and one graph replay per chunk of 16 iterations, and
    every trial counted on the device."""
    started = row["iterations"] - (row["status"] in (
        "Maximum Iterations Reached", "Too Many Function Evaluations"))
    assert row["jit"]["reads"] == row["jit"]["replays"] == -(-started // 16)
    assert row["jit"]["slots"] == row["fun_evals"] - started


def test_campaign_keeps_host_and_jit_rows(tmp_path):
    """A jit row sits beside the host row of the same (problem, mode,
    drive), and a row recorded without ``lm_drive`` counts as the host's."""
    path = str(tmp_path / "out.json")
    old = {"problem": "p", "mode": "cholesky", "drive": "f64", "status": "a"}
    jit = dict(old, lm_drive="jit", status="b")
    campaign.merge_write(path, {"card": "c"}, [old])
    campaign.merge_write(path, {"card": "c"}, [jit])
    assert sorted(r["status"] for r in _load(path)["rows"]) == ["a", "b"]
    campaign.merge_write(path, {"card": "c"}, [dict(old, lm_drive="host",
                                                    status="c")])
    assert sorted(r["status"] for r in _load(path)["rows"]) == ["b", "c"]


def test_campaign_merges_rows_by_key(tmp_path):
    """The artifact keeps one row per (problem, mode, drive): a later row
    replaces an earlier one, others stay."""
    path = str(tmp_path / "out.json")
    a = {"problem": "p", "mode": "cholesky", "drive": "f64", "status": "CRASHED"}
    b = {"problem": "p", "mode": "qrchol", "drive": "f64", "status": "x"}
    campaign.merge_write(path, {"card": "c1"}, [a, b])
    a2 = dict(a, status="Success (Energy Flatlined)")
    campaign.merge_write(path, {"card": "c2"}, [a2])
    data = _load(path)
    assert data["header"] == {"card": "c2"}
    assert sorted(r["mode"] for r in data["rows"]) == ["cholesky", "qrchol"]
    assert [r["status"] for r in data["rows"] if r["mode"] == "cholesky"] == [
        "Success (Energy Flatlined)"]


def test_plan_rows():
    """45 rows for the three stand-ins, 2 for the Ladybug stand-in."""
    rows = campaign.plan(["p16", "p126", "p257", "ladybug"], MODES, DRIVES)
    assert len(rows) == 47
    assert [r for r in rows if r[0] == "ladybug"] == [
        ("ladybug", "cholesky", "f64"), ("ladybug", "cholesky", "df32")]


def test_campaign_table(tmp_path):
    """``flatline_campaign.py --table``: one line per row, a crashed row
    first and without numbers, the p16 row's gaps taken to the scipy
    oracle (zero for the oracle's own statistics)."""
    oracle = _load(ORACLE[P16])
    row = {"problem": P16, "mode": "qrchol", "drive": "f64",
           "status": "Success (Energy Flatlined)", "iterations": 60,
           "wall_s": 2.0, "it_per_s": 30.0, "peak_bytes": 2e9,
           "post": oracle["post"]}
    crashed = {"problem": P16, "mode": "spqr", "drive": "df32", "status": "CRASHED"}
    path = str(tmp_path / "rows.json")
    campaign.merge_write(path, {"card": "NVIDIA H100 80GB HBM3, 700.00 W",
                                "commit": "abc"}, [row, crashed])
    lines = campaign.table(path).splitlines()
    assert lines[0] == "Card: NVIDIA H100 80GB HBM3, 700.00 W; abc."
    assert lines[4].startswith(f"| {P16} | df32 | spqr | CRASHED |")
    assert lines[5] == ("| problem-16-22106 | f64 | qrchol | flatline | 60 | 2.000 | "
                        "30.00 | 2.00 | 0.072808 | 2147.76 | 59903 | scipy "
                        "| 0.00e+00 dom | 0.00e+00 |")

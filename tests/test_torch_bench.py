"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU at
p16: its workload against a direct ``lm.minimize``, against the JAX
package's bench.py CPU branch, its command line and its gates.

Tolerances:
- Against the port's own ``lm.minimize`` with
  ``flatline_campaign.drive_config("f64", 3)``: the same iterations,
  evaluations, status and energy, bit for bit (the bench adds nothing to
  the run it times).
- Against JAX's ``lm.minimize(problem, "cholesky", LMConfig(drive="jit",
  max_iter=3))`` (bench.py:45-55 on the CPU): the same iterations,
  evaluations and status, energies within 1e-6 relative (the gap measured
  after iteration 3 is ~1e-7; printed with ``pytest -rP``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.solvers import lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch as bench  # noqa: E402
import flatline_campaign as campaign  # noqa: E402
import oracle_prefix as op  # noqa: E402

SCRIPT = os.path.join(ROOT, "bench_torch.py")
P16 = os.path.join(ROOT, campaign.PROBLEMS["p16"])
JAX_RTOL = 1e-6


@pytest.fixture(scope="module")
def p16_f64():
    """The bench's workload on p16 in float64, 3 iterations, one timed run:
    (problem, its record, the lines it printed)."""
    problem = pm.load_bal_problem(P16, device="cpu")
    lines = []
    (record,) = bench.run_workloads(problem, "p16", ("cholesky",),
                                    campaign.drive_config("f64", 3), 1, "cpu",
                                    out=lines.append)
    return problem, record, lines


def _script(*args):
    return subprocess.run([sys.executable, SCRIPT, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_config_is_bench_py_on_the_jit_drive(monkeypatch):
    """The script runs ``flatline_campaign.drive_config``: bench.py's
    accelerator config by default, its CPU branch with ``--geometry f64``,
    both on the jit drive."""
    df32 = campaign.drive_config("df32", 100)
    assert (df32.drive, df32.max_iter, df32.geometry, df32.matmul_dtype) == (
        "jit", 100, "df32", "float32")
    f64 = campaign.drive_config("f64", 3)
    assert (f64.drive, f64.max_iter, f64.geometry, f64.matmul_dtype) == (
        "jit", 3, None, None)
    seen = []
    monkeypatch.setattr(bench, "run_workloads",
                        lambda problem, name, modes, cfg, *a, **kw: seen.append(cfg) or [])
    monkeypatch.setattr(bench, "last_line", lambda *a: {"correct": True})
    for argv, want in ((["--max-iter", "100"], df32), (["--geometry", "f64",
                                                       "--max-iter", "3"], f64)):
        assert bench.main(["--problem", "p16", "--device", "cpu", *argv],
                          out=lambda _: None) == 0
        assert seen[-1] == want


def test_workload_equals_direct_minimize(p16_f64):
    problem, record, _ = p16_f64
    direct = lm.minimize(problem, "cholesky", campaign.drive_config("f64", 3),
                         device="cpu")
    want = {"status": lm.STATUS_STRINGS[direct.status],
            "iterations": direct.iterations, "fun_evals": direct.fun_evals,
            "energy": direct.energy}
    for run in record["runs"]:
        assert {k: run[k] for k in want} == want
    assert {k: record[k] for k in want} == want


def test_workload_matches_jax_bench_cpu_branch(p16_f64):
    _, record, _ = p16_f64
    jp = jpm.load_bal_problem(P16, dtype=jnp.float64)
    res_j = jlm.minimize(jp, mode="cholesky",
                         config=jlm.LMConfig(drive="jit", max_iter=3))
    run = record["runs"][0]
    gap = abs(run["energy"] - float(res_j.energy)) / abs(float(res_j.energy))
    print(f"gap bench p16 f64 cholesky vs JAX bench.py CPU branch, 3 "
          f"iterations: {gap:.3g}")
    assert (run["status"], run["iterations"], run["fun_evals"]) == (
        jlm.STATUS_STRINGS[jlm.LMStatus(int(res_j.status))],
        int(res_j.iterations), int(res_j.fun_evals))
    assert gap <= JAX_RTOL


def test_workload_lines_and_gates(p16_f64):
    _, record, lines = p16_f64
    assert [line["bench"] for line in lines] == ["warmup", "run", "workload"]
    assert "runs" not in lines[-1]
    assert record["gates"] == {"replay": True, "no_capture_in_window": True,
                               "kernels_vs_plain": None, "descent": True,
                               "reference": True, "control": True,
                               "numerics": True}
    assert record["correct"] and record["repeats"] == 1
    run = record["runs"][0]
    assert run["captured"] is False and run["reads"] == run["replays"] == 1
    assert record["reads"] == record["replays"] == [1]
    assert record["it_per_s"]["median"] == run["it_per_s"] > 0
    assert record["energy"] < record["initial_energy"]
    assert record["peak_bytes"] is None and record["reserved_bytes"] is None


def test_workload_control_line(p16_f64):
    """Gate (d3) on the 3-iteration p16 workload: one more run through the
    timed route's loop, observed, so chunked (its states observed too, so
    one iteration a chunk: three replays, three reads), ending where the
    warm-up ended;
    every iteration passes the rules, and the line says the run reached
    neither a rejected trial nor a mid-range accept (its rho stays above
    the clamp's 0.9368 over iterations 1-3)."""
    _, record, lines = p16_f64
    control = record["control"]
    assert lines[-1]["control"] == control
    assert control["captured"] is False and control["chunked"] is True
    assert control["replays"] == control["reads"] == 3
    assert control["same_endpoint"] and control["rules"] and control["ok"]
    assert control["broken"] is None and control["seconds"] > 0
    assert (control["iterations"], control["accepts"]) == (3, 3)
    assert control["unreached"] == ["rejection", "mid-range accept",
                                    "second growth"]
    assert control["gaps"]["carry"] <= bench.CONTROL_F_RTOL
    assert control["gaps"]["accept"] <= bench.CONTROL_LAM_RTOL


def test_script_last_line():
    proc = _script("--problem", "p16", "--repeats", "1", "--max-iter", "2",
                   "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    last = lines[-1]
    assert last["metric"] == "lm_iter_per_sec_p16_cholesky"
    assert last["unit"] == "iter/s"
    assert last["vs_baseline"] == 1.0 and last["baseline"] is None
    assert last["value"] == last["p16_cholesky_iter_per_sec"] > 0
    assert last["p16_qrchol_iter_per_sec"] > 0
    assert last["correct"] is True and last["device"] == "cpu"
    runs = [line for line in lines if line.get("bench") == "run"]
    assert [r["mode"] for r in runs] == ["cholesky", "qrchol"]
    assert lines[0]["bench"] == "header" and lines[0]["config"]["geometry"] == "df32"


@pytest.mark.parametrize("args", [
    ["--repeats", "0"],
    ["--modes", "cholesky,householder"],
    ["--max-iter", "0"],
    ["--problem", "no-such-problem.txt"],
], ids=["repeats0", "unknown-mode", "max-iter0", "no-problem"])
def test_bad_arguments_exit_nonzero(args):
    proc = _script("--problem", "p16", "--device", "cpu", *args)
    assert proc.returncode != 0
    assert proc.stdout == ""


def _run(**kw):
    run = {"mode": "cholesky", "status": lm.STATUS_STRINGS[lm.LMStatus.MaxItersReached],
           "iterations": 4, "fun_evals": 6, "energy": 10.0, "lam": 1e-3, "wall_s": 0.5,
           "it_per_s": 8.0, "captured": False, "capture_s": 0.0, "replays": 1,
           "reads": 1, "launches": {}, "peak_bytes": None, "points_ok": True}
    run.update(kw)
    return run


FAULTS = {
    "clean": ({}, None),
    "energy-differs": (dict(energy=10.0 + 1e-12), "replay"),
    "fun-evals-differ": (dict(fun_evals=7), "replay"),
    "captured": (dict(captured=True), "no_capture_in_window"),
    "no-descent": (dict(energy=20.0), "descent"),
    "non-finite": (dict(energy=float("inf")), "descent"),
    "bad-stop": (dict(status=lm.STATUS_STRINGS[lm.LMStatus.TooManyFunctionEvaluation]),
                 "descent"),
    "bad-points": (dict(points_ok=False), "descent"),
    "off-reference": ({}, "reference"),
    "off-control": ({}, "control"),
    "off-numerics": ({}, "numerics"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_gates_catch_each_fault(fault):
    """A timed run that departs from the warm-up, or captured, fails its
    gate; a workload whose runs (warm-up too) do not descend fails its own;
    either makes the workload incorrect. The clean one passes every gate."""
    change, gate = FAULTS[fault]
    cfg = campaign.drive_config("f64", 3)
    if gate == "descent":
        warm, runs = _run(**change), [_run(**change), _run(**change)]
    else:
        warm, runs = _run(), [_run(), _run(**change)]
    reference = {"within": gate != "reference"}
    control = {"ok": gate != "control"}
    numerics = {"ok": gate != "numerics"}
    rec = bench.workload("p16", "cholesky", cfg, warm, runs, 15.0, None, None,
                         reference, control, numerics)
    failed = [k for k, v in rec["gates"].items() if v is False]
    assert failed == ([gate] if gate else [])
    assert rec["correct"] is (gate is None)


def test_kernel_gate_fails_the_workload():
    cfg = campaign.drive_config("df32", 3)
    kernels = {"iterations": [4, 4], "fun_evals": [6, 7], "energy": [10.0, 10.0],
               "rel_gap": 0.0, "kernels_captured": False,
               "kernels_launches": {"chain_blocks": 1, "chain_energy": 1}, "ok": False}
    rec = bench.workload("p16", "cholesky", cfg, _run(), [_run()], 15.0, None,
                         kernels, {"within": True}, {"ok": True}, {"ok": True})
    assert not rec["correct"]
    assert bench.kernels_vs_plain(None, ("cholesky", "qrchol"), cfg,
                                  torch.device("cpu")) == {"cholesky": None,
                                                           "qrchol": None}


#: Runs that gate (b)'s reruns must reproduce: p16 df32 to the iteration
#: budget (iterations 1 and 5 reject a trial), to a flatline stop at
#: iteration 3, and to a lambda-max stop at iteration 1's rejected trial.
RERUN_STOPS = {
    "budget": (dict(max_iter=6), lm.LMStatus.MaxItersReached),
    "flatline": (dict(max_iter=6, tol_fun=0.5), lm.LMStatus.Success),
    "lambda-max": (dict(max_iter=6, lambda_max=0.01), lm.LMStatus.ExceededLambdaMax),
}


def _observed(problem, cfg):
    states = []
    res = lm.minimize(problem, "cholesky", cfg, device="cpu",
                      states=lambda *s: states.append(s))
    return res, states


@pytest.mark.parametrize("drive", ["host", "jit"])
@pytest.mark.parametrize("stop", RERUN_STOPS)
def test_reruns_reproduce_the_run(p16_f64, drive, stop):
    """Gate (b)'s reruns (``rerun_iterations``) where the chain is the same
    on both sides (the plain one, on the CPU): each iteration of a p16
    df32 run, run again alone from that run's state and lambda before it
    (``resume_at``), gives that iteration's record bit for bit and stops
    as the run did, and the last rerun ends at the run's endpoint. So a
    part in gate (b) is the chain's, not the reruns'."""
    limits, status = RERUN_STOPS[stop]
    cfg = dataclasses.replace(campaign.drive_config("df32", 1), drive=drive, **limits)
    res, states = _observed(p16_f64[0], cfg)
    assert res.status == status
    records = [r for _, _, r in states]
    rerun, stops, last = bench.rerun_iterations(p16_f64[0], "cholesky", cfg,
                                                torch.device("cpu"), states)
    parting = bench.records_parting(records, rerun)
    assert parting["bitwise_to"] == len(records) and parting["parted"] is None
    assert stops == [lm.LMStatus.MaxItersReached] * (len(records) - 1) + [status]
    assert (last.status, last.iterations, last.fun_evals, last.energy, last.lam) == (
        res.status, res.iterations, res.fun_evals, res.energy, res.lam)


@pytest.mark.parametrize("fault", ["energy-scaled", "step-scaled"])
def test_reruns_part_on_a_fault_of_the_chain(p16_f64, fault):
    """A fault in the reruns' chain alone (both chain energies x (1 +
    ENERGY_FAULT), or the reduced right-hand side x (1 + STEP_FAULT)) parts
    gate (b)'s comparison at the first iteration, on the prepare's energy
    or on the accepted one."""
    cfg = dataclasses.replace(campaign.drive_config("df32", 2), drive="host")
    _, states = _observed(p16_f64[0], cfg)
    with bench.planted(bench.planted_faults()[fault]):
        rerun, _, _ = bench.rerun_iterations(p16_f64[0], "cholesky", cfg,
                                             torch.device("cpu"), states)
    parting = bench.records_parting([r for _, _, r in states], rerun)
    assert parting["within_to"] == 0 and parting["parted"]["iteration"] == 1


def test_last_line_baseline():
    recs = [{"mode": "cholesky", "it_per_s": {"median": 2.0}, "correct": True},
            {"mode": "qrchol", "it_per_s": {"median": 1.0}, "correct": False}]
    line = bench.last_line("p16", recs, "cpu")
    assert line == {"metric": "lm_iter_per_sec_p16_cholesky", "value": 2.0,
                    "unit": "iter/s", "vs_baseline": 1.0, "baseline": None,
                    "p16_cholesky_iter_per_sec": 2.0,
                    "p16_qrchol_iter_per_sec": 1.0, "correct": False,
                    "device": "cpu"}


@pytest.mark.parametrize("key,name", [
    ("p257", "p257"), ("ladybug", "ladybug"),
    ("/data/problem-21-11315-pre.txt", "problem-21-11315-pre"),
    ("data/problem-16-22106-pre.txt.gz", "problem-16-22106-pre"),
])
def test_problem_name(key, name):
    assert bench.problem_name(key) == name


def test_incorrect_run_exits_one_after_printing(monkeypatch):
    """A timed run that departs from its warm-up: the script prints every
    line, the last with ``correct: false``, and returns 1."""
    calls = []
    minimize = lm.minimize

    def drifting(*args, **kw):
        res = minimize(*args, **kw)
        calls.append(res)
        return res._replace(energy=res.energy * (1 + 1e-9 * (len(calls) - 1)))

    monkeypatch.setattr(bench.lm, "minimize", drifting)
    lines = []
    rc = bench.main(["--problem", "p16", "--geometry", "f64", "--modes",
                     "cholesky", "--max-iter", "1", "--repeats", "1",
                     "--device", "cpu"], out=lines.append)
    # The warm-up, the timed run, gate (d3)'s observed run and gate (d)'s
    # float64 prefix.
    assert rc == 1 and len(calls) == 4
    assert [line.get("bench") for line in lines] == [
        "header", "warmup", "run", "workload", None]
    assert lines[-1]["correct"] is False
    assert lines[-2]["gates"]["replay"] is False


# -- gate (d): a reference outside the port ----------------------------------


def test_p16_workload_held_to_the_oracle_prefix(p16_f64):
    """The p16 float64 cholesky workload's gate (d): its 3-iteration run
    stopped at its budget, so no endpoint is compared; its float64 prefix
    pairs the scipy oracle's first P16_PREFIX_ITERS iterations within
    oracle_prefix.CHOLESKY (measured <= 9.9e-6 relative)."""
    _, record, _ = p16_f64
    ref = record["reference"]
    print(f"p16 f64 cholesky prefix vs the scipy oracle: {ref['prefix']['gaps']}")
    assert ref["endpoint"] is None and "iteration budget" in ref["endpoint_none"]
    prefix = ref["prefix"]
    assert prefix["source"].startswith(bench.P16_ORACLE)
    assert [p["iter"] for p in prefix["pairs"]] == list(
        range(1, bench.P16_PREFIX_ITERS + 1))
    assert prefix["matched"] is None and prefix["budget"] == op.CHOLESKY
    assert prefix["gaps"]["first_rel"] < op.CHOLESKY["first_rel"]
    assert prefix["gaps"]["rel"] < op.CHOLESKY["rel"]
    assert prefix["gaps"]["rel_above"] < op.CHOLESKY["rel_above"]
    assert prefix["within"] and ref["within"] and "error" not in ref


#: (problem, mode, geometry) of each endpoint reference: the scipy oracle at
#: p16, the JAX package's campaign rows at p126 and p257.
ENDPOINTS = (("p16", "cholesky", "f64"), ("p16", "spqr", "f64"),
             ("p257", "cholesky", "df32"), ("p257", "qrchol", "df32"),
             ("p126", "moreqr", "f64"))


@pytest.mark.parametrize("shift", [1.0, 1.1], ids=["at-the-row", "objective+10%"])
@pytest.mark.parametrize("name,mode,geometry", ENDPOINTS,
                         ids=["-".join(e) for e in ENDPOINTS])
def test_endpoint_gate(monkeypatch, name, mode, geometry, shift):
    """(d1) passes where the endpoint's statistics are the reference row's
    own, and fails where its true objective lies 10% above (beyond both
    the float64 2% and the df32 9% budget)."""
    source, ref = bench.endpoint_reference(name, mode, geometry)
    post = dict(ref, true_objective=ref["true_objective"] * shift)
    monkeypatch.setattr(campaign, "post_statistics", lambda state, obs: post)
    monkeypatch.setattr(op, "run_row", lambda *a, **kw: {
        "iterations": 2, "pairs": [], "matched": None, "gaps": {},
        "budget": op.CHOLESKY, "within": True})
    monkeypatch.setattr(bench, "prefix_reference", lambda *a: ("stub", None))
    warm = {"status": lm.STATUS_STRINGS[lm.LMStatus.Success]}
    gate = bench.reference_gate(types.SimpleNamespace(obs=None), name, mode,
                                geometry, warm, None, "cpu")
    assert gate["endpoint"]["source"] == source
    assert gate["endpoint"]["gaps"]["obj_rtol"] == pytest.approx(shift - 1.0)
    assert gate["endpoint"]["within"] is (shift == 1.0)
    assert gate["within"] is (shift == 1.0)


@pytest.mark.parametrize("name,attr", [("p16", "P16_ORACLE"), ("p257", "JAX_ROWS"),
                                       ("ladybug", "LADYBUG_PREFIX")])
@pytest.mark.parametrize("how", ["missing", "unreadable"])
def test_missing_reference_fails_the_gate(monkeypatch, tmp_path, name, attr, how):
    """A reference file that is missing or not JSON fails gate (d), naming
    the file; nothing is skipped and no LM run starts."""
    path = tmp_path / "reference.json"
    if how == "unreadable":
        path.write_text("{not json")
    monkeypatch.setattr(bench, attr, str(path))
    monkeypatch.setattr(op, "run_row", lambda *a, **kw: pytest.fail("ran"))
    warm = {"status": lm.STATUS_STRINGS[lm.LMStatus.Success]}
    gate = bench.reference_gate(None, name, "cholesky", "df32", warm, None, "cpu")
    assert gate["within"] is False and str(path) in gate["error"]
    rec = bench.workload(name, "cholesky", campaign.drive_config("df32", 3),
                         _run(), [_run()], 15.0, None, None, gate, {"ok": True},
                         {"ok": True})
    assert rec["gates"]["reference"] is False and not rec["correct"]


def test_a_problem_without_reference_fails_the_gate():
    warm = {"status": lm.STATUS_STRINGS[lm.LMStatus.Success]}
    gate = bench.reference_gate(None, "problem-21-11315-pre", "cholesky", "f64",
                                warm, None, "cpu")
    assert gate["within"] is False and "no float64 prefix reference" in gate["error"]


def test_broken_damping_update_fails_only_the_reference_gate(monkeypatch, p16_f64):
    """Lambda's factor on an accept inverted (1 / the Nielsen factor: lambda
    grows 3x on a good step where it should shrink 3x), in the one function
    both LM drives use: the runs still replay bit for bit, capture nothing
    and descend, so gates (a)-(c) pass, and the workload is incorrect on
    the reference gates alone: on (d), lambda's factor from one iteration
    to the next lies 8x off the oracle's (beyond LAM_FACTOR_REL's 1e-2)
    from iteration 2, and the energies at the third iteration 2.8e-4
    (beyond CHOLESKY's 1e-4); on (d3), iteration 1's lambda lies 8x off
    the rule's."""
    problem, clean, _ = p16_f64
    nielsen = lm._nielsen
    monkeypatch.setattr(lm, "_nielsen", lambda rho: 1.0 / nielsen(rho))
    cfg = campaign.drive_config("f64", 3)
    jit, host = (lm.minimize(problem, "cholesky", dataclasses.replace(cfg, drive=d),
                             device="cpu") for d in ("jit", "host"))
    assert jit.energy == host.energy != clean["energy"]
    (record,) = bench.run_workloads(problem, "p16", ("cholesky",), cfg, 1, "cpu",
                                    out=lambda _: None)
    print(f"broken damping: prefix gaps {record['reference']['prefix']['gaps']}")
    assert record["gates"] == {"replay": True, "no_capture_in_window": True,
                               "kernels_vs_plain": None, "descent": True,
                               "reference": False, "control": False,
                               "numerics": True}
    assert record["control"]["broken"]["rule"] == "accept"
    assert record["control"]["broken"]["iteration"] == 1
    gaps = record["reference"]["prefix"]["gaps"]
    assert gaps["first_rel"] > op.CHOLESKY["first_rel"]
    assert gaps["lam_factor_rel"] > op.LAM_FACTOR_REL
    assert not record["correct"]


def test_broken_damping_update_fails_the_p257_prefix(monkeypatch):
    """The same fault against the scipy oracle's two logged p257 iterations,
    the prefix gate (d2) of bench_torch.py's p257 workloads: the damping
    factor of iteration 2 lies 8x off the oracle's (the energies 1.2e-4,
    the statistics at iteration 2 within their budget), so the row fails;
    without the fault the factor is within 3.7e-4 (the log's four
    significant digits)."""
    loaded = op.load("p257", "cpu")
    clean = op.run_row("p257", "cholesky", "jit", "cpu", loaded)
    nielsen = lm._nielsen
    monkeypatch.setattr(lm, "_nielsen", lambda rho: 1.0 / nielsen(rho))
    broken = op.run_row("p257", "cholesky", "jit", "cpu", loaded)
    print(f"p257 prefix gaps: clean {clean['gaps']}, broken {broken['gaps']}")
    assert clean["within"] and clean["gaps"]["lam_factor_rel"] < op.LAM_FACTOR_REL
    assert broken["gaps"]["lam_factor_rel"] > op.LAM_FACTOR_REL
    assert not broken["within"]


def test_jax_reference_holds_the_port_prefix():
    """jax_reference.py's function (the JAX package's float64 cholesky on its
    host drive, 2 iterations) on a small generated problem, and the port's
    float64 prefix on the port's own generated copy held to it by
    oracle_prefix.run_row under CHOLESKY, as the bench holds the Ladybug
    stand-in (measured: energies 7.2e-8 relative, objective 8.1e-9)."""
    import jax_reference
    from bundleadjustment_benchmarks_tpu.utils import balgen as jbalgen
    from bundleadjustment_benchmarks_tpu_torch.utils import balgen

    kw = dict(seed=3, mean_degree=4.3)
    ref = jax_reference.jax_prefix(jbalgen.generate_bal_like(30, 800, **kw))
    problem = pm.from_bal_dataset(balgen.generate_bal_like(30, 800, **kw),
                                  device="cpu")
    matched = ref["matched"]
    row = op.run_row("balgen-30-800", "cholesky", "jit", "cpu", (
        problem, [(r["iter"], r["energy"], r["lam"]) for r in ref["trace"]],
        (matched["iter"], matched["stats"])))
    print(f"port vs JAX prefix, balgen 30 x 800: {row['gaps']}")
    assert [p["iter"] for p in row["pairs"]] == [1, 2] and ref["iterations"] == 3
    assert row["budget"] == op.CHOLESKY and row["within"]
    assert row["gaps"]["lam_factor_rel"] < op.LAM_FACTOR_REL
    assert row["matched"]["port"]["n_inliers"] == matched["stats"]["n_inliers"]


def test_ladybug_reference_artifact():
    """The committed JAX prefix on the Ladybug stand-in: the stand-in's shape
    and seed, float64 cholesky on JAX's host drive, two iterations that
    descend with lambda after each, the statistics at the second, JAX's
    version and the seconds."""
    ref = bench._read_json(bench.LADYBUG_PREFIX)
    n, m, _ = campaign.LADYBUG
    assert (ref["n_cameras"], ref["n_points"], ref["seed"]) == (n, m, n)
    assert ref["n_observations"] == 670568
    assert (ref["mode"], ref["geometry"], ref["lm_drive"]) == ("cholesky", "f64", "host")
    energies = [r["energy"] for r in ref["trace"]]
    assert [r["iter"] for r in ref["trace"]] == [1, 2] and energies[1] < energies[0]
    assert all(r["lam"] > 0 for r in ref["trace"])
    assert ref["matched"]["iter"] == 2 and ref["energy"] == energies[-1]
    assert ref["jax"] and ref["seconds"] > 0

"""Gate (d3) of ``bench_torch.py``, "control": ``bench_torch.control_gate``
holds every iteration of a run to the reference's LM rules
(BacktrackLevMarqCholesky.h:299-353) from the run's iteration records.

- Records made by hand from a real run, each changed to break one rule,
  fail with that rule named.
- The checker passes on the JAX package's host-drive records (its metrics
  JSONL, converted) and on the port's jit and host records of the same
  generated problem (``balgen`` 12 x 300, seed 2: float64 cholesky to its
  flatline stop, with rejected trials, second growths and accepts in the
  factor's middle range; and with a low ``lambda_max``, the port's 1e-9
  and JAX's 1, where it stops on lambda-max), and on the port's df32
  records (plain chain) of that problem. Both packages' runs of it take
  the same path at 2, 4 and 8 threads (measured; on other problems the JAX
  run's path moves with ``OMP_NUM_THREADS``).
- Each of ``bench_torch.planted_faults``' rule faults (gate "control";
  its numeric faults are ``tests/test_torch_numerics.py``'s) breaks
  control on both drives of
  that problem, and makes bench_torch.py's p16 float64 cholesky workload
  at ``max_iter`` P16_MAX_ITER incorrect on control, where the clean
  workload stays correct. p16 reaches its first mid-range accept at
  iteration 6 and its first rejected trials at iteration 19 or 20,
  depending on torch's thread count (measured at 2, 4 and 8 threads), so
  ``drive_config("f64", 3)`` would reach neither.

Tolerances are the gate's own: lambda within CONTROL_LAM_RTOL (1e-12) of
the rule, the carried energy within CONTROL_F_RTOL (1e-12; measured 0 in
float64 and <= 6.5e-15 with df32's plain chain here).
"""

import dataclasses
import inspect
import json
import os
import sys

import jax.numpy as jnp
import pytest

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu.utils import balgen as jbalgen
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.solvers import lm
from bundleadjustment_benchmarks_tpu_torch.utils import balgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch as bench  # noqa: E402
import flatline_campaign as campaign  # noqa: E402

#: The generated problem: (cameras, points) and its keywords.
GEN = (12, 300)
GEN_KW = dict(seed=2, mean_degree=4.3)
#: Float64 cholesky on it, to its flatline stop (the port after 48
#: iterations, JAX after 63); and with a lambda_max that a climb of
#: rejected trials crosses, to a lambda-max stop there: the port's
#: iteration 33 climb of 5 trials (from lambda_min) at its 4th, JAX's
#: iteration 10 climb of 9 trials at its 8th. The port's float64 reduced
#: solve (a refined Cholesky) and JAX's (a QR) part at rounding level from
#: iteration 2 on, and the climbs sit where the two paths have parted.
F64 = lm.LMConfig(max_iter=200)
LOW_MAX = dataclasses.replace(F64, lambda_max=1e-9)
JAX_LOW_MAX = dataclasses.replace(F64, lambda_max=1.0)
DF32 = dataclasses.replace(F64, geometry="df32", matmul_dtype="float32")
#: The p16 bench workload that reaches both a rejection and a mid-range accept.
P16_MAX_ITER = 20
STATUS = lm.STATUS_STRINGS


@pytest.fixture(scope="module")
def generated():
    return pm.from_bal_dataset(balgen.generate_bal_like(*GEN, **GEN_KW),
                               device="cpu")


def port_run(problem, cfg, drive="host"):
    """(records, endpoint) of one port run."""
    records = []
    res = lm.minimize(problem, "cholesky", dataclasses.replace(cfg, drive=drive),
                      device="cpu", records=records)
    return records, {"status": STATUS[res.status], "iterations": res.iterations,
                     "fun_evals": res.fun_evals, "energy": res.energy,
                     "lam": res.lam}


@pytest.fixture(scope="module")
def runs(generated):
    """The host drive's records and endpoint of F64 and LOW_MAX."""
    return {"flatline": port_run(generated, F64),
            "lambda-max": port_run(generated, LOW_MAX)}


def coverage(check):
    return {k: check[k] for k in ("iterations", "accepts", "rejected_trials",
                                  "mid_accepts", "second_growths")}


def assert_reaches_everything(check):
    assert check["rejected_trials"] >= 1 and check["mid_accepts"] >= 1
    assert check["second_growths"] >= 1 and check["unreached"] == []


# -- hand-made records: one rule broken each ---------------------------------------


def _set(records, k, **kw):
    """``records`` with iteration ``k``'s (1-based) fields replaced."""
    out = list(records)
    out[k - 1] = out[k - 1]._replace(**kw)
    return out


def _first(records, pred):
    return next(k for k, r in enumerate(records, 1) if pred(r))


def linear(r):
    """lam_out of accepted record ``r`` had its factor been max(1/3,
    1 - (2 rho - 1)) instead of Nielsen's."""
    factor = max(1 / 3, 1 - (2 * r.rho - 1) ** 3)
    return r.lam_out / factor * max(1 / 3, 2 - 2 * r.rho)


def _mutations():
    """{case: (run, change, rule)}: ``change(records, endpoint, cfg)``
    returns the changed (records, endpoint, cfg)."""
    mid = lambda rs: _first(rs, lambda r: r.accepted  # noqa: E731
                            and r.rho < bench.RHO_CLAMP)
    multi = lambda rs: _first(rs, lambda r: r.n_trials >= 3)  # noqa: E731
    return {
        "clean-flatline": ("flatline", lambda rs, ep, c: (rs, ep, c), None),
        "clean-lambda-max": ("lambda-max", lambda rs, ep, c: (rs, ep, c), None),
        "lam0-not-carried": ("flatline", lambda rs, ep, c: (
            _set(rs, 5, lam0=rs[4].lam0 * (1 + 1e-15)), ep, c), "carry"),
        "state-not-advanced": ("flatline", lambda rs, ep, c: (
            _set(rs, 5, f=rs[3].f), ep, c), "carry"),
        "endpoint-energy": ("flatline", lambda rs, ep, c: (
            rs, dict(ep, energy=ep["energy"] * (1 + 1e-12)), c), "carry"),
        "endpoint-lambda": ("lambda-max", lambda rs, ep, c: (
            rs, dict(ep, lam=ep["lam"] * 2), c), "carry"),
        "last-trial-lambda": ("lambda-max", lambda rs, ep, c: (
            _set(rs, len(rs), lam_out=rs[-1].lam_out * 1.5), ep, c), "growth"),
        "accepted-uphill": ("flatline", lambda rs, ep, c: (
            _set(rs, 3, energy_out=rs[2].f * 1.01), ep, c), "accept"),
        "rejected-downhill": ("lambda-max", lambda rs, ep, c: (
            _set(rs, len(rs), energy_out=rs[-1].f * 0.99), ep, c), "accept"),
        "negative-rho": ("flatline", lambda rs, ep, c: (
            _set(rs, 2, rho=-0.5), ep, c), "accept"),
        "middle-range-factor": ("flatline", lambda rs, ep, c: (
            _set(rs, mid(rs), lam_out=linear(rs[mid(rs) - 1])), ep, c), "accept"),
        "grew-past-lambda-max": ("flatline", lambda rs, ep, c: (
            rs, ep, dataclasses.replace(c, lambda_max=rs[multi(rs) - 1].lam0)),
            "stop"),
        "ran-after-reject": ("lambda-max", lambda rs, ep, c: (
            rs + [rs[-1]], ep, c), "stop"),
        "ran-after-flatline": ("flatline", lambda rs, ep, c: (
            rs + [rs[-1]._replace(f=rs[-1].energy_out, lam0=rs[-1].lam_out)],
            ep, c), "stop"),
        "stopped-early": ("flatline", lambda rs, ep, c: (
            rs[:10], dict(ep, iterations=10, energy=rs[9].energy_out,
                          lam=rs[9].lam_out), c), "stop"),
        "wrong-status": ("lambda-max", lambda rs, ep, c: (
            rs, dict(ep, status=STATUS[lm.LMStatus.Success]), c), "stop"),
        "wrong-iterations": ("flatline", lambda rs, ep, c: (
            rs, dict(ep, iterations=ep["iterations"] + 1), c), "stop"),
        "past-max-iter": ("flatline", lambda rs, ep, c: (
            rs, ep, dataclasses.replace(c, max_iter=len(rs) - 1)), "stop"),
        "fun-evals": ("flatline", lambda rs, ep, c: (
            rs, dict(ep, fun_evals=ep["fun_evals"] + 1), c), "count"),
        "no-trial": ("flatline", lambda rs, ep, c: (
            _set(rs, 7, n_trials=0), ep, c), "count"),
    }


MUTATIONS = _mutations()


@pytest.mark.parametrize("case", MUTATIONS)
def test_hand_made_records_break_one_rule(runs, case):
    """A real run's records pass; each change breaks the rule named, at the
    iteration changed or at the end of the run."""
    run, change, rule = MUTATIONS[case]
    records, endpoint = runs[run]
    cfg = LOW_MAX if run == "lambda-max" else F64
    records, endpoint, cfg = change(list(records), dict(endpoint), cfg)
    check = bench.control_gate(records, cfg, endpoint)
    print(f"{case}: {check['broken']}")
    assert check["ok"] is (rule is None)
    assert (check["broken"] or {}).get("rule") == rule


def test_checker_needs_no_drive_code(monkeypatch, runs):
    """The checker calls none of the rules it checks: with lm._nielsen,
    lm.growth_table and lm.DeviceLoop raising, it still passes a clean run
    and fails a changed one; its source names none of them."""
    records, endpoint = runs["lambda-max"]

    def boom(*a, **kw):
        raise AssertionError("the checker called the drive's rules")

    for name in ("_nielsen", "growth_table", "DeviceLoop"):
        monkeypatch.setattr(lm, name, boom)
    assert bench.control_gate(records, LOW_MAX, endpoint)["ok"]
    broken = _set(records, len(records), lam_out=records[-1].lam_out * 2)
    assert bench.control_gate(broken, LOW_MAX, endpoint)["broken"]["rule"] == "growth"
    source = inspect.getsource(bench.control_gate)
    assert not any(name in source for name in ("_nielsen", "growth_table",
                                               "DeviceLoop"))


# -- real records: the JAX package's and the port's ------------------------------


def jax_records(rows, lam_rule, energy):
    """The JAX host drive's metrics JSONL rows (one per trial) as iteration
    records. The JSONL holds no trial energy, so an accepted iteration's
    energy_out is the next iteration's f (the last's the result's energy),
    and an iteration that accepts on its first trial started at the lambda
    the one before ended with (the first at the rule's, ``lam_rule``)."""
    groups = []
    for row in rows:
        if groups and groups[-1][0]["iter"] == row["iter"]:
            groups[-1].append(row)
        else:
            groups.append([row])
    records = []
    for trials in groups:
        first, last = trials[0], trials[-1]
        accepted = last["status"] == "Accepted"
        if first["status"] == "Rejected":
            lam0 = first["lambda"]
        else:
            lam0 = records[-1].lam_out if records else lam_rule
        records.append(lm.IterRecord(first["f"], last["rho"], lam0, last["lambda"],
                                     len(trials), accepted, first["f"]))
    for k, rec in enumerate(records):
        if rec.accepted:
            out = records[k + 1].f if k + 1 < len(records) else energy
            records[k] = rec._replace(energy_out=out)
    return records


@pytest.mark.parametrize("cfg", [F64, JAX_LOW_MAX], ids=["flatline", "lambda-max"])
def test_checker_passes_jax_host_records(tmp_path, cfg):
    """The JAX package's float64 cholesky on its host drive, on the JAX
    package's copy of the generated problem, its metrics JSONL converted."""
    problem = jpm.from_bal_dataset(jbalgen.generate_bal_like(*GEN, **GEN_KW),
                                   dtype=jnp.float64)
    jcfg = jlm.LMConfig(drive="host", max_iter=cfg.max_iter,
                        lambda_max=cfg.lambda_max)
    path = tmp_path / "metrics.jsonl"
    res = jlm.minimize(problem, "cholesky", jcfg, metrics_path=str(path))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    lam_rule = float(jlm._make_kernels(problem, "cholesky", jcfg)[0](problem.state)[2])
    records = jax_records(rows, lam_rule, float(res.energy))
    endpoint = {"status": jlm.STATUS_STRINGS[jlm.LMStatus(int(res.status))],
                "iterations": int(res.iterations), "fun_evals": int(res.fun_evals),
                "energy": float(res.energy), "lam": float(res.lam)}
    check = bench.control_gate(records, cfg, endpoint)
    print(f"JAX host records: {coverage(check)}, gaps {check['gaps']}")
    assert check["ok"], check["broken"]
    assert_reaches_everything(check)


@pytest.mark.parametrize("drive", ["jit", "host"])
@pytest.mark.parametrize("cfg", [F64, LOW_MAX, DF32],
                         ids=["flatline", "lambda-max", "df32"])
def test_checker_passes_port_records(generated, runs, cfg, drive):
    """The port's records of the same problem on both drives: they pass,
    and the jit drive's equal the host drive's."""
    records, endpoint = port_run(generated, cfg, drive)
    check = bench.control_gate(records, cfg, endpoint)
    print(f"port {drive} records: {coverage(check)}, gaps {check['gaps']}")
    assert check["ok"], check["broken"]
    assert_reaches_everything(check)
    if cfg is not DF32:
        assert (records, endpoint) == runs["flatline" if cfg is F64 else "lambda-max"]
    else:
        assert records == port_run(generated, cfg, "host" if drive == "jit" else "jit")[0]


# -- planted faults -------------------------------------------------------------


FAULTS = {name: fault for name, fault in bench.planted_faults().items()
          if fault.gate == "control"}


@pytest.mark.parametrize("drive", ["jit", "host"])
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_breaks_control(monkeypatch, generated, fault, drive):
    """Each planted fault, in the function both drives call, breaks control
    on the generated problem's float64 run on either drive."""
    for module, attr, replacement in FAULTS[fault].patches:
        monkeypatch.setattr(module, attr, replacement)
    records, endpoint = port_run(generated, F64, drive)
    check = bench.control_gate(records, F64, endpoint)
    print(f"{fault} on {drive}: {check['broken']}")
    assert check[FAULTS[fault].reach] >= 1 and not check["ok"]


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_planted_fault_fails_the_p16_workload(monkeypatch, fault):
    """bench_torch.py's p16 float64 cholesky workload at P16_MAX_ITER
    iterations: clean, it reaches rejected trials, a second growth and
    mid-range accepts, and is correct; under each fault it is incorrect on
    control. The middle-range factor passes every other gate, (d2)
    included: its prefix's factors sit at the clamp. The squared growth
    fails gate (e) too: its trials solve at the squared growth's lambda,
    and the step does not solve the normal equations at the rule's. The
    inverted factor fails (d2) too."""
    problem = pm.load_bal_problem(os.path.join(ROOT, campaign.PROBLEMS["p16"]),
                                  device="cpu")
    if fault:
        for module, attr, replacement in FAULTS[fault].patches:
            monkeypatch.setattr(module, attr, replacement)
    (record,) = bench.run_workloads(problem, "p16", ("cholesky",),
                                    campaign.drive_config("f64", P16_MAX_ITER), 1,
                                    "cpu", out=lambda _: None)
    control = record["control"]
    failed = sorted(k for k, v in record["gates"].items() if v is False)
    print(f"p16 f64 cholesky, {P16_MAX_ITER} iterations, fault {fault}: failed "
          f"{failed}, control {coverage(control)}, broken {control['broken']}, "
          f"gaps {control['gaps']}, {control['seconds']:.3g} s")
    assert control["chunked"] and control["captured"] is False
    assert control["same_endpoint"]
    if fault is None:
        assert record["correct"] and failed == []
        assert control["iterations"] == P16_MAX_ITER
        assert_reaches_everything(control)
    else:
        assert not record["correct"] and not control["rules"]
        assert failed == {"inverted": ["control", "reference"],
                          "growth-squared": ["control", "numerics"]}.get(
                              fault, ["control"])

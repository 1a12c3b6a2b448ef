"""The port's float64 LM held to the scipy oracle's prefix on the p126 and
p257 stand-ins (``oracle_prefix.py``, the counterpart of the JAX package's
``benchmarks/p126_oracle_check.py``), on the CPU, and the committed run of
the card (``torch_results/oracle_prefix_h100.json``).

Budgets (``oracle_prefix.CHOLESKY``, gaps printed with ``pytest -rP``):
cholesky energies within 1e-4 relative at iterations 1-3, and at every
one within 1e-1 and no more than 2e-3 above the oracle's (past the first
iterations the path turns on the rounding, and starts 1e-15 apart end
p126's 15 iterations up to 2.7e-2 below the oracle); at the oracle state's iteration the
inlier mean error within 1e-3 px, the true objective within 1e-2 relative
and the inlier count within 1%. The card's other modes at p126 are held to
the JAX package's test_oracle_prefix budget (``oracle_prefix.JAX_BUDGET``).
Every mode's lambda factor from one iteration to the next, over the
budget's first iterations, within ``oracle_prefix.LAM_FACTOR_REL`` (1e-2;
the logs' four significant digits leave <= 3.7e-4). The host and the jit LM drives take the same path: equal energies and
statistics.
"""

import json
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import oracle_prefix as op  # noqa: E402

ARTIFACT = os.path.join(ROOT, op.ARTIFACT)
#: (problem key, accepted iterations in the oracle's log, the npz's iteration)
PREFIXES = (("p126", 15, 10), ("p257", 2, 2))
LENGTH = {key: n for key, n, _ in PREFIXES}
MATCHED = {key: k for key, _, k in PREFIXES}


@pytest.mark.parametrize("key,n,k", PREFIXES, ids=[p[0] for p in PREFIXES])
def test_parse_oracle_logs(key, n, k):
    log, npz, _ = op.CONFIGS[key]
    trace = op.parse_oracle_trace(os.path.join(op.RESULTS, log))
    assert [it for it, _, _ in trace] == list(range(1, n + 1))
    first = {"p126": (4563.62, 0.004208), "p257": (7602.09, 0.001641)}[key]
    assert trace[0][1:] == first
    assert all(b[1] < a[1] for a, b in zip(trace, trace[1:]))
    assert int(np.load(os.path.join(op.RESULTS, npz))["it"]) == k


@pytest.fixture(scope="module")
def cpu_rows():
    """p257 cholesky on both LM drives and p126 cholesky on the jit drive,
    on the CPU: {(key, lm_drive): row}."""
    loaded = op.load("p257", "cpu")
    rows = [op.run_row("p257", "cholesky", d, "cpu", loaded)
            for d in op.LM_DRIVES]
    rows.append(op.run_row("p126", "cholesky", "jit", "cpu"))
    return {(r["key"], r["lm_drive"]): r for r in rows}


def _hold(row: dict) -> None:
    """``row`` against the oracle: the pairs of every logged iteration, the
    statistics at the oracle state's iteration, each gap (recomputed here)
    within the mode's budget."""
    budget = op.budget_for(row["mode"])
    key = row["key"]
    print(f"{key} {row['mode']} {row['lm_drive']}: "
          + ", ".join(f"{k} {v:.3g}" for k, v in row["gaps"].items()))
    assert [p["iter"] for p in row["pairs"]] == list(range(1, LENGTH[key] + 1))
    assert row["matched"]["iter"] == MATCHED[key]
    gaps = op.gaps(row["pairs"], row["matched"], budget)["gaps"]
    assert gaps == row["gaps"]
    for name, limit in budget.items():
        if name != "first_iters" and limit is not None:
            assert gaps[name] < limit, (name, gaps[name], limit)
    assert row["within"]


@pytest.mark.parametrize("key,lm_drive", [("p257", "host"), ("p257", "jit"),
                                          ("p126", "jit")],
                         ids=["p257-host", "p257-jit", "p126-jit"])
def test_prefix_within_budget(cpu_rows, key, lm_drive):
    _hold(cpu_rows[(key, lm_drive)])
    # Both logs have lambda: the damping factor is held too.
    assert cpu_rows[(key, lm_drive)]["gaps"]["lam_factor_rel"] < op.LAM_FACTOR_REL


def test_host_equals_jit_at_p257(cpu_rows):
    host, jit = cpu_rows[("p257", "host")], cpu_rows[("p257", "jit")]
    assert [p["port_energy"] for p in host["pairs"]] == [
        p["port_energy"] for p in jit["pairs"]]
    assert host["matched"]["port"] == jit["matched"]["port"]
    assert (host["iterations"], host["fun_evals"], host["energy"]) == (
        jit["iterations"], jit["fun_evals"], jit["energy"])


@pytest.mark.parametrize("late,within", [
    (-2.7e-2, True), (-9e-2, True), (-1.1e-1, False),
    (1.1e-3, True), (2.1e-3, False)],
    ids=["below-2.7e-2", "below-9e-2", "below-1.1e-1", "above-1.1e-3",
         "above-2.1e-3"])
def test_cholesky_budget_holds_a_lag_tightly_and_a_lead_loosely(late, within):
    """Past the first iterations a cholesky energy may lie below the
    oracle's by up to ``rel`` (a deeper descent: perturbed starts reach
    2.7e-2 below at p126) and above it by less than ``rel_above``; the
    first iterations stay within ``first_rel`` either way."""
    oracle = [5000.0, 4000.0, 3000.0, 2500.0, 2400.0]
    port = oracle[:3] + [e * (1.0 + late) for e in oracle[3:]]
    pairs = [{"iter": i, "oracle_energy": o, "port_energy": e,
              "rel": abs(e - o) / o} for i, (o, e) in enumerate(zip(oracle, port), 1)]
    got = op.gaps(pairs, None, op.CHOLESKY)
    assert got["within"] is within
    assert got["gaps"]["rel_above"] == pytest.approx(max(0.0, late))
    early = [dict(p, port_energy=p["oracle_energy"] * (1.0 - 2e-4),
                  rel=2e-4) if p["iter"] == 2 else p for p in pairs]
    assert not op.gaps(early, None, op.CHOLESKY)["within"]


def _artifact():
    if not os.path.exists(ARTIFACT):
        pytest.skip("the card's oracle-prefix artifact is not recorded")
    with open(ARTIFACT) as f:
        return json.load(f)


def test_card_artifact_header():
    header = _artifact()["header"]
    assert "H100" in header["kind"] and header["card"].startswith(header["kind"])
    assert header["card"].endswith(" W")


def test_card_artifact_within_budget():
    """Every row the card recorded: cholesky at p126 and p257 on both LM
    drives, the other modes at p126; each within its budget, and the two
    drives on one path."""
    rows = {(r["key"], r["mode"], r["lm_drive"]): r for r in _artifact()["rows"]}
    want = {(key, "cholesky", d) for key in LENGTH for d in op.LM_DRIVES}
    want |= {("p126", mode, "jit") for mode in op.OTHER_MODES}
    assert want <= set(rows)
    for row in rows.values():
        assert row["platform"] == "gpu"
        _hold(row)
    for key in LENGTH:
        host, jit = rows[(key, "cholesky", "host")], rows[(key, "cholesky", "jit")]
        assert [p["port_energy"] for p in host["pairs"]] == [
            p["port_energy"] for p in jit["pairs"]]
        assert host["matched"]["port"] == jit["matched"]["port"]

"""Scipy-oracle prefix anchors of the PyTorch/CUDA port: its float64 LM
trajectory and statistics on the p126 and p257 stand-ins held to the
independent scipy oracle's first iterations.

    python3 oracle_prefix.py [--key p126|p257|all]
        [--json torch_results/oracle_prefix_h100.json] [--commit TEXT]
        [--device cpu]

The counterpart of ``benchmarks/p126_oracle_check.py --key p126|p257`` for
the port (``bundleadjustment_benchmarks_tpu_torch``). The oracle
(``benchmarks/cpu_reference.py``, the reference's algorithm in scipy) takes
minutes to an hour per LM iteration at these sizes, so what exists of it is
a prefix, committed under ``benchmarks/results``: the accepted iterations
of its verbose log (``cpu_p126_flatline.log``, 15; ``cpu_p257_prefix.log``,
2) and its state at iteration ``it`` of an npz (``cpu_p126_state.npz`` at
10, ``cpu_p257_state.npz`` at 2).

For each problem and LM drive (``LMConfig.drive``: the host loop and the
device-resident one) the script runs float64 cholesky from the loaded state
to the log's last iteration, with ``lm.minimize(..., trace=...)``, whose
records hold the energy after each accepted step, as the oracle's log does;
pairs each logged iteration with the port's (``pairs``: iter,
oracle_energy, port_energy, rel); and computes the reference's statistics
(Utils.h:15-68, focal 1.0, inlier threshold 0.5 px, as the JAX script does)
on the port's state and on the oracle's at the npz's iteration
(``matched``). At p126 the other four modes (qrchol, qrkit, moreqr, spqr)
run too, in float64 on the jit drive. A row's ``wall_s`` is its first run
alone, with no warm-up: on the jit drive it includes the graph's capture
(``jit.capture_s``). Every row is held to its budget (``budget_for``):
cholesky to ``CHOLESKY`` (tight on the first iterations, then one-sided:
past them the path turns on the rounding, and a deeper descent than the
oracle's is no fault), the other modes to the JAX package's
test_oracle_prefix budget (tests/test_flatline_parity.py:105-131).

The artifact (``--json``, relative to this file's directory) holds a
header that names the card (``nvidia-smi --query-gpu=name,power.limit``)
and one row per (problem, mode, drive, lm_drive), merged into what the file
held. Runs on the CUDA device; without one and without ``--device cpu`` it
exits 2 and runs nothing. Exit code 1: a row missed its budget. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import flatline_campaign as campaign  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch import resolve_device  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch.solvers import lm  # noqa: E402

RESULTS = os.path.join(HERE, "benchmarks", "results")
#: Per problem: the oracle's log, its state npz and the BAL stand-in.
CONFIGS = {
    "p126": ("cpu_p126_flatline.log", "cpu_p126_state.npz",
             "data/problem-126-40037-pre.txt.gz"),
    "p257": ("cpu_p257_prefix.log", "cpu_p257_state.npz",
             "data/problem-257-65132-pre.txt.gz"),
}
OTHER_MODES = ("qrchol", "qrkit", "moreqr", "spqr")
#: The LM drives of the cholesky rows: host equal to jit is part of the gate.
LM_DRIVES = ("host", "jit")
#: cholesky: energies within ``first_rel`` at iterations 1..``first_iters``;
#: at every one within ``rel`` and no more than ``rel_above`` above the
#: oracle's (``rel_above`` is signed: the port's largest excess over the
#: oracle, negative where it is below at every iteration); at the matched
#: iteration the inlier mean error within ``inlier_px``, the true objective
#: within ``obj_rtol`` and the inlier count within ``inlier_count_rtol``,
#: all relative to the oracle. Measured on the CPU (float64, both drives
#: alike): p126 rel <= 5.8e-6 at iterations 1-3; 8.9e-5 px, 1.2e-3 and
#: 1.0e-4 at iteration 10; p257 7.3e-7 and 4.6e-7; 2.1e-6 px, 2.3e-7 and
#: 5.5e-6 at iteration 2. Past its first five iterations the p126 path
#: turns on the rounding: from starts 1e-15 apart (relative, in the points)
#: one code's float64 cholesky ends its 15 iterations anywhere from 2.7e-2
#: below the oracle to 1.1e-3 above it (24 starts on an H100 and 7 on the
#: CPU, of two versions of the chain; each energy that of its state to
#: 1e-15). So the budget holds a lag behind the oracle tightly and a lead
#: loosely. The other modes at p126 (jit drive): rel <= 1.7e-3 over the
#: first 5, <= 2.2e-3 over 15; <= 1.1e-4 px, 1.3e-3 and 1.1e-3.
CHOLESKY = dict(first_rel=1e-4, first_iters=3, rel=1e-1, rel_above=2e-3,
                inlier_px=1e-3, obj_rtol=1e-2, inlier_count_rtol=1e-2)
#: The JAX package's budget (tests/test_flatline_parity.py:118-131): the
#: first five pairs within 1e-2, all within 1e-1, 5e-3 px and 5%.
JAX_BUDGET = dict(first_rel=1e-2, first_iters=5, rel=1e-1, inlier_px=5e-3,
                  obj_rtol=5e-2, inlier_count_rtol=None)
#: Where the reference logs lambda after each iteration: the damping
#: update's factor (lambda over the previous iteration's) within this of
#: the reference's over iterations 2..``first_iters``, in every mode (a
#: mode's initial lambda may differ from the cholesky oracle's, its update
#: may not). An energy moves little where lambda is small against the
#: Hessian, so a wrong update can pass the energies of a short prefix: an
#: inverted Nielsen factor (lambda x 3 where it should shrink 3x) leaves
#: p257's first two energies 1.2e-4 apart, its factor 8x off.
LAM_FACTOR_REL = 1e-2
ARTIFACT = "torch_results/oracle_prefix_h100.json"
ORACLE_ROW = re.compile(
    r"^\s*(\d+) Accepted ([0-9.eE+-]+) rho=[0-9.eE+-]+ lam=([0-9.eE+-]+)")


def budget_for(mode: str) -> dict:
    return CHOLESKY if mode == "cholesky" else JAX_BUDGET


def parse_oracle_trace(path: str) -> list:
    """[(iter, energy, lambda)] of the accepted rows of the oracle's log."""
    with open(path) as f:
        return [(int(m[1]), float(m[2]), float(m[3]))
                for m in map(ORACLE_ROW.match, f) if m]


def oracle_state(path: str, problem):
    """(iteration, BAState) of the oracle's npz on the problem's device. The
    npz holds f = K(0,0) = K(1,1), already negated, and pre-scaled k1, k2:
    the port's conventions, so the fields map one to one
    (p126_oracle_check.py:167-184)."""
    d = np.load(path)
    like = problem.state.T
    f = torch.as_tensor(d["f"], dtype=like.dtype)
    K = torch.zeros((f.shape[0], 3, 3), dtype=like.dtype)
    K[:, 0, 0] = K[:, 1, 1] = f
    K[:, 2, 2] = 1.0
    arrays = {"K": K, "R": d["R"], "T": d["T"], "k1": d["k1"], "k2": d["k2"],
              "points": d["X"]}
    state = dataclasses.replace(problem.state, **{
        k: torch.as_tensor(v, dtype=like.dtype).to(like.device)
        for k, v in arrays.items()})
    return int(d["it"]), state


def load(key: str, device, problem=None):
    """(problem on ``device``, oracle trace, (iteration, the reference's
    statistics of the oracle's state there)); the stand-in is read unless
    ``problem``, already loaded, is given. ``run_row`` takes any such
    triple, its last item None where the reference has no state."""
    log, npz, bal = CONFIGS[key]
    if problem is None:
        problem, _ = campaign.load_problem(os.path.join(HERE, bal), device)
    k, state = oracle_state(os.path.join(RESULTS, npz), problem)
    return (problem, parse_oracle_trace(os.path.join(RESULTS, log)),
            (k, campaign.post_statistics(state, problem.obs)))


def gaps(pairs: list, matched, budget: dict) -> dict:
    """The row's largest gaps to the oracle (the statistics' only where
    ``matched``) and whether each is within ``budget``."""
    first = pairs[:budget["first_iters"]]
    out = {"first_rel": max((p["rel"] for p in first), default=math.inf),
           "rel": max((q["rel"] for q in pairs), default=math.inf),
           "rel_above": max(((q["port_energy"] - q["oracle_energy"])
                             / q["oracle_energy"] for q in pairs), default=math.inf)}
    factors = [p["lam_factor_rel"] for p in first if "lam_factor_rel" in p]
    if factors:
        out["lam_factor_rel"] = max(factors)
    if matched is not None:
        o, p = matched["oracle"], matched["port"]
        out.update(
            inlier_px=abs(p["inlier_mean_reprojection_error"]
                          - o["inlier_mean_reprojection_error"]),
            obj_rtol=abs(p["true_objective"] - o["true_objective"])
            / abs(o["true_objective"]),
            inlier_count_rtol=abs(p["n_inliers"] - o["n_inliers"]) / o["n_inliers"])
    within = all(out[k] < v for k, v in dict(
        budget, lam_factor_rel=LAM_FACTOR_REL).items() if k in out and v is not None)
    return {"gaps": out, "within": within}


def run_row(key: str, mode: str, lm_drive: str, device=None, loaded=None) -> dict:
    """One row: float64 ``mode`` on the ``lm_drive`` LM drive from the
    loaded state to the oracle log's last iteration (timed between two
    synchronizes), its energies paired with the log's, and the statistics
    of its state and the oracle's at the npz's iteration (a second run to
    that iteration where it comes earlier). ``loaded``: ``load(key)``'s
    value, to share one load among rows, or another reference's triple in
    its form (``key`` then names the row). A row is ``within`` where every
    logged iteration is paired and every gap within ``budget_for(mode)``.
    Raises without CUDA and without ``device``."""
    dev = resolve_device(device)
    problem, trace_o, matched_o = loaded or load(key, dev)
    last = trace_o[-1][0]
    cfg = lm.LMConfig(drive=lm_drive, max_iter=last)
    trace = []
    campaign._sync(dev)
    t0 = time.perf_counter()
    res = lm.minimize(problem, mode, cfg, device=dev, trace=trace)
    campaign._sync(dev)
    wall = time.perf_counter() - t0
    jit = dict(lm.LAST_JIT_RUN) if lm_drive == "jit" else None
    port = {r["iter"]: r for r in trace}
    pairs = []
    for it, e, lam in trace_o:
        if it not in port:
            continue
        p = port[it]
        pair = {"iter": it, "oracle_energy": e, "port_energy": p["energy"],
                "rel": abs(p["energy"] - e) / e}
        if lam is not None:
            pair.update(oracle_lam=lam, port_lam=p["lam"])
            prev = pairs[-1] if pairs else {}
            if prev.get("iter") == it - 1 and "oracle_lam" in prev:
                pair["lam_factor_rel"] = abs(p["lam"] / prev["port_lam"] * (
                    prev["oracle_lam"] / lam) - 1.0)
        pairs.append(pair)
    matched = None
    if matched_o is not None:
        k, stats_o = matched_o
        res_k = res if k == last else lm.minimize(
            problem, mode, dataclasses.replace(cfg, max_iter=k), device=dev)
        matched = {"iter": k, "oracle": stats_o,
                   "port": campaign.post_statistics(res_k.state, problem.obs)}
    name = os.path.basename(CONFIGS[key][2]) if key in CONFIGS else key
    row = {"problem": name, "key": key,
           "mode": mode, "drive": "f64", "lm_drive": lm_drive,
           "platform": "gpu" if dev.type == "cuda" else dev.type,
           "status": lm.STATUS_STRINGS[res.status], "iterations": res.iterations,
           "fun_evals": res.fun_evals, "energy": res.energy, "wall_s": wall,
           "jit": jit, "pairs": pairs, "matched": matched,
           "budget": budget_for(mode)}
    row.update(gaps(pairs, matched, budget_for(mode)))
    row["within"] = row["within"] and len(pairs) == len(trace_o)
    if lm_drive == "jit":
        lm.clear_graphs()
    return row


def plan(keys) -> list:
    """(key, mode, LM drive) of every row, problem by problem: cholesky on
    each of ``LM_DRIVES``, then at p126 the other modes on the jit drive."""
    rows = []
    for key in keys:
        rows += [(key, "cholesky", d) for d in LM_DRIVES]
        if key == "p126":
            rows += [(key, mode, "jit") for mode in OTHER_MODES]
    return rows


def run(keys=tuple(CONFIGS), device=None) -> list:
    """Every row of ``plan(keys)`` on ``device`` (CUDA unless
    named; without CUDA and without ``device`` it raises)."""
    dev = resolve_device(device)
    loaded, rows = {}, []
    for key, mode, lm_drive in plan(keys):
        if key not in loaded:
            loaded = {key: load(key, dev)}
        rows.append(run_row(key, mode, lm_drive, dev, loaded[key]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--key", default="all", choices=("p126", "p257", "all"))
    ap.add_argument("--json", default=ARTIFACT,
                    help="the artifact, relative to this file's directory")
    ap.add_argument("--commit", default=None,
                    help="what the header names as the code's version "
                    "(default: git rev-parse HEAD)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"oracle_prefix: {e}", file=sys.stderr)
        return 2
    header = {"card": campaign.card() if device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "commit": args.commit or campaign.commit()}
    print(json.dumps({"header": header}), flush=True)
    keys = tuple(CONFIGS) if args.key == "all" else (args.key,)
    rows = run(keys, device)
    for row in rows:
        print(json.dumps({k: row[k] for k in ("problem", "mode", "lm_drive",
                                              "iterations", "energy", "wall_s",
                                              "gaps", "within")}), flush=True)
    campaign.merge_write(os.path.join(HERE, args.json), header, rows)
    missed = [r for r in rows if not r["within"]]
    print(f"wrote {len(rows)} rows to {args.json}; {len(missed)} outside "
          "their budget", flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Gate (e)'s measures on the card, clean and under planted faults: the
readings that set ``bench_torch.NUMERICS_BOUNDS`` and the planted faults'
sizes (PERF.md).

    python3 numerics_probe.py            # needs CUDA; ~2.5 minutes on an H100
    python3 numerics_probe.py --device cpu --runs p16-f64

Each run is ``lm.minimize`` of ``bench_torch.py``'s configuration (the jit
drive, max_iter 100) with its states observed (a replay and a read per
iteration of the graph that ``bench_torch.py`` times), captured afresh
under its fault. It prints one JSON line per run: the workload and fault,
the run's status and iterations, ``bench_torch.numerics_gate``'s record,
each accepted step's (iteration, lambda, eta, its allowance, omega), and
the largest over the run of three measures that gate (e) does not hold,
computed here only (r = (J^T J + lam I) dx + g, g = J^T f, D =
diag(J^T J) + lam, of the run's own chain, as the gate's): scaled, the
Jacobi-scaled relative residual ||D^-1/2 r|| / ||D^-1/2 g||;
rel_residual, ||r|| / ||g||; and omega, the componentwise backward error
max_i |r_i| / (|J|^T |J| |dx| + lam |dx| + |J|^T |f|)_i (Oettli-Prager,
with J and f perturbed). Last it prints the card. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bench_torch as bench  # noqa: E402
import flatline_campaign as campaign  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch import resolve_device  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch.solvers import lm  # noqa: E402

#: The runs, by group: (problem, geometry, mode, fault, its size).
RUNS = {
    "p257-df32": [("p257", "df32", m, None, None)
                  for m in ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")]
    + [("p257", "df32", "cholesky", f, None)
       for f in ("energy-scaled", "middle-range", "growth-squared", "inverted")],
    "p257-step": [("p257", "df32", "cholesky", "step-scaled", s)
                  for s in (1e-3, 3e-3, 1e-2, 1e-1, 0.3, 1.0, 3.0)],
    "ladybug-df32": [("ladybug", "df32", m, None, None) for m in ("cholesky", "qrchol")],
    "p16-f64": [("p16", "f64", m, None, None)
                for m in ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")]
    + [("p16", "f64", "cholesky", "step-scaled", s) for s in (1e-5, 1e-4, 1e-3)],
}


def diagnostics(problem, blocks, dxp, dxc, lam: float) -> dict:
    """(scaled, rel_residual, omega) of the step (dxp, dxc) against
    ``blocks`` (module docstring), in float64 through the blocks."""
    n, m = dxc.shape[0], dxp.shape[0]
    Jc, Jp, f = (t.to(torch.float64) for t in blocks)
    jt, jtj = bench.block_products(problem, n, m)
    flat = torch.cat([dxc.flatten(), dxp.flatten()])

    def cat(pair):
        return torch.cat([t.flatten() for t in pair])

    g = cat(jt(Jc, Jp, f))
    r = cat(jtj(Jc, Jp, dxc, dxp)) + lam * flat + g
    Ac, Ap = Jc.abs(), Jp.abs()
    den = cat(jtj(Ac, Ap, dxc.abs(), dxp.abs())) + lam * flat.abs() + cat(jt(Ac, Ap, f.abs()))
    cam, pt = problem.obs.cam_idx.long(), problem.obs.pt_idx.long()
    d = torch.cat([
        f.new_zeros((n, 9)).index_add_(0, cam, (Jc * Jc).sum(1)).flatten(),
        f.new_zeros((m, 3)).index_add_(0, pt, (Jp * Jp).sum(1)).flatten()]) + lam
    held = den > 0
    omega = torch.where(held, r.abs() / torch.where(held, den, torch.ones_like(den)),
                        torch.zeros_like(den)).max()
    scaled, rel, omega = torch.stack([
        torch.linalg.vector_norm(r / d.sqrt()) / torch.linalg.vector_norm(g / d.sqrt()),
        torch.linalg.vector_norm(r) / torch.linalg.vector_norm(g), omega]).tolist()
    return {"scaled": scaled, "rel_residual": rel, "omega": omega}


def probe(problem, name: str, geometry: str, mode: str, fault, size, dev) -> dict:
    """One run of ``RUNS`` and its readings."""
    cfg = campaign.drive_config(geometry, bench.MAX_ITER)
    patches = (bench.planted(bench.planted_faults(
        **({"step": size} if fault == "step-scaled" else {}))[fault])
        if fault else contextlib.nullcontext())
    states = []
    lm.clear_graphs()
    t0 = time.perf_counter()
    try:
        with patches:
            res = lm.minimize(problem, mode, cfg, device=dev,
                              states=lambda *s: states.append(s))
    finally:
        lm.clear_graphs()
    run_s = time.perf_counter() - t0
    status = lm.STATUS_STRINGS[res.status]
    gate = bench.numerics_gate(problem, bench.start_state(problem, cfg), states,
                               cfg, status)
    top = {k: {"max": -math.inf} for k in ("scaled", "rel_residual", "omega")}
    by_iteration = []
    prev = bench.start_state(problem, cfg)
    discard = status == lm.STATUS_STRINGS[lm.LMStatus.Success] and cfg.discard_final_step
    for i, (it, state, record) in enumerate(states):
        if not record.accepted or (discard and i == len(states) - 1):
            continue
        dxp, dxc = bench.recover_step(prev, state)
        lam = bench._trial_lambda(record, cfg)
        blocks = bench.run_blocks(problem, prev, geometry)
        step = bench.step_residual(problem, blocks, dxp, dxc, lam,
                                   bench.recovery_err(prev, state, geometry))
        got = diagnostics(problem, blocks, dxp, dxc, lam)
        by_iteration.append([it, lam, step["eta"], step["allowance"], got["omega"]])
        for k, v in got.items():
            if v > top[k]["max"]:
                top[k] = {"max": v, "iteration": it, "lam": lam}
        prev = state
    return {"probe": "numerics", "problem": name, "geometry": geometry, "mode": mode,
            "fault": fault, "size": size, "status": status,
            "iterations": res.iterations, "run_s": run_s, "numerics": gate,
            "diagnostic": top, "by_iteration": by_iteration}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS), help=f"comma list of {', '.join(RUNS)}")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"numerics_probe: {e}", file=sys.stderr)
        return 2
    problems = {}
    for group in args.runs.split(","):
        for name, geometry, mode, fault, size in RUNS[group]:
            if name not in problems:
                problems.clear()
                problems[name] = campaign.load_problem(name, dev)[0]
            print(json.dumps(probe(problems[name], name, geometry, mode, fault, size,
                                   dev)), flush=True)
    print(json.dumps({"card": campaign.card() if dev.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

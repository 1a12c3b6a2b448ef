"""Flatline campaign of the PyTorch/CUDA port: every solver mode to the
reference's energy-flatline stop, on the card.

    python3 flatline_campaign.py [--problems p16,p126,p257,ladybug]
        [--modes cholesky,qrchol,qrkit,moreqr,spqr] [--drives f64,df32,df32p]
        [--lm-drive host|jit] [--max-iter 2000] [--timeout 1800]
        [--json torch_results/flatline_h100.json] [--commit TEXT] [--device cpu]
    python3 flatline_campaign.py --table    # the artifact as a markdown table

The counterpart of ``benchmarks/parity_campaign.py`` for the port
(``bundleadjustment_benchmarks_tpu_torch``): each (problem, mode, drive) row
runs ``lm.minimize`` from the loaded state to the stop of ``lm.lm_loop``
(|E - max(history)| < tol_fun E, BacktrackLevMarqCholesky.h:343-350) or to
the lambda-max stop, and records the status, iterations, evaluations,
energy, the wall time of the run alone (after a 2-iteration warm-up that
builds the kernels; no load and no build inside the window), LM iterations
per second, the peak device memory, the chain kernels' launches, the
accepted energy and lambda of every iteration (``trace``) and the reference's
post-run statistics (Utils.h:15-68) at focal 1.0 and tau 0.5 px.

Drives (all ``max_iter=2000``): ``f64`` the defaults; ``df32`` two-float
geometry, float32 Schur stacks and the CUDA chain kernels; ``df32p`` df32
then up to 300 float64 polish iterations (``LMConfig.polish_iters``).
``--lm-drive`` picks the LM drive around them (``LMConfig.drive``): the
host loop (the default) or the device-resident one (``jit``, whose warm-up
captures the CUDA graph that the timed run replays); each row records it as
``lm_drive``.
Problems: the in-repo stand-ins p16, p126 and p257 (``data/``) under every
mode and drive, and ``ladybug``, a stand-in of BAL's Ladybug
problem-1723-156502 generated in memory (``utils/balgen``, seed 1723), under
cholesky on f64 and df32 only.

Every row runs in a subprocess of its own with a wall limit (``--timeout``),
since a CUDA fault poisons its process: a crash or a timeout is a row with
status CRASHED or TIMEOUT under the same problem key, and the campaign then
exits 1. The artifact is rewritten after every row, rows with the same
(problem, mode, drive, lm_drive) replaced (a row without ``lm_drive`` ran
the host drive); its header names the card
(``nvidia-smi --query-gpu=name,power.limit``) and ``--commit``. Runs on the
CUDA device; without one and without ``--device cpu`` it exits 2 and runs
nothing. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from bundleadjustment_benchmarks_tpu_torch import resolve_device  # noqa: E402

PROBLEMS = {
    "p16": "data/problem-16-22106-pre.txt.gz",
    "p126": "data/problem-126-40037-pre.txt.gz",
    "p257": "data/problem-257-65132-pre.txt.gz",
}
#: BAL's Ladybug problem-1723-156502-pre (N, M, K): the stand-in has these
#: N and M and mean point degree K / M (as chip_smoke.py generates it).
LADYBUG = (1723, 156502, 678718)
LADYBUG_NAME = "problem-1723-156502-pre-standin"
#: The Ladybug stand-in runs these modes and drives only.
LADYBUG_MODES = ("cholesky",)
LADYBUG_DRIVES = ("f64", "df32")
MODES = ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")
DRIVES = ("f64", "df32", "df32p")
#: Post-run statistics as the JAX campaign computes them.
FOCAL, TAU = 1.0, 0.5
POLISH_ITERS = 300
WARMUP_ITERS = 2
SENTINEL = "FLATLINE_ROW:"
#: The JAX campaign's budgets per drive (tests/test_flatline_parity.py:54-86,
#: where each is measured): a row's post statistics against a reference's.
BUDGETS = {
    "f64": dict(inlier_px=1e-3, obj_rtol=2e-2, inlier_count_rtol=0.04),
    "df32p": dict(inlier_px=1e-2, obj_rtol=9e-2, inlier_count_rtol=0.25),
    "df32": dict(inlier_px=1e-2, obj_rtol=9e-2, inlier_count_rtol=0.25),
}
ARTIFACT = "torch_results/flatline_h100.json"


def drive_config(drive: str, max_iter: int):
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm

    if drive == "f64":
        return lm.LMConfig(max_iter=max_iter)
    df32 = dict(max_iter=max_iter, geometry="df32", matmul_dtype="float32")
    if drive == "df32":
        return lm.LMConfig(**df32)
    if drive == "df32p":
        return lm.LMConfig(polish_iters=POLISH_ITERS, **df32)
    raise ValueError(f"unknown drive {drive!r}")


def load_problem(key: str, device):
    """(BAProblem on ``device``, problem name): a key of PROBLEMS, "ladybug",
    or the path of a BAL file (named by its basename)."""
    from bundleadjustment_benchmarks_tpu_torch.models import problem as pm

    if key == "ladybug":
        from bundleadjustment_benchmarks_tpu_torch.utils import balgen

        n, m, k = LADYBUG
        ds = balgen.generate_bal_like(n, m, seed=n, mean_degree=k / m)
        return pm.from_bal_dataset(ds, device=device), LADYBUG_NAME
    path = os.path.join(HERE, PROBLEMS[key]) if key in PROBLEMS else key
    return pm.load_bal_problem(path, device=device), os.path.basename(path)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def post_statistics(state, obs) -> dict:
    """The reference's post-run statistics (``utils/stats.py``)."""
    from bundleadjustment_benchmarks_tpu_torch.utils import stats

    st = stats.error_statistics(state, obs, FOCAL, TAU)
    return {
        "mean_reprojection_error": float(st.mean_reprojection_error),
        "inlier_mean_reprojection_error": float(st.inlier_mean_reprojection_error),
        "n_inliers": int(st.n_inliers),
        "n_observations": int(st.n_observations),
        "true_objective": float(stats.true_objective(state, obs, FOCAL, TAU)),
    }


def run_row(problem, name: str, mode: str, drive: str, max_iter: int = 2000,
            device=None, lm_drive: str = "host") -> tuple:
    """One campaign row: a warm-up of WARMUP_ITERS iterations (each phase of
    df32p), then ``lm.minimize`` from the problem's state to its stop,
    timed between two synchronizes, on the LM drive ``lm_drive`` (a jit
    row records the timed run's ``lm.LAST_JIT_RUN``: host reads, graph
    replays, trials; its graph is freed after it). Returns (row, the final
    BAState)."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm

    dev = resolve_device(device)
    problem = problem.to(dev)
    cfg = dataclasses.replace(drive_config(drive, max_iter), drive=lm_drive)
    warm = dataclasses.replace(cfg, max_iter=WARMUP_ITERS,
                               polish_iters=min(cfg.polish_iters, WARMUP_ITERS))
    lm.minimize(problem, mode, warm, device=dev)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cuda_chain.reset_launches()
    trace = []
    t0 = time.perf_counter()
    res = lm.minimize(problem, mode, cfg, device=dev, trace=trace)
    _sync(dev)
    wall = time.perf_counter() - t0
    row = {
        "problem": name, "mode": mode, "drive": drive, "lm_drive": lm_drive,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "status": lm.STATUS_STRINGS[res.status],
        "iterations": res.iterations, "fun_evals": res.fun_evals,
        "energy": res.energy, "wall_s": wall,
        "it_per_s": res.iterations / wall,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "launches": dict(cuda_chain.LAUNCHES),
        "post": post_statistics(res.state, problem.obs),
        "trace": trace,
        "jit": dict(lm.LAST_JIT_RUN) if lm_drive == "jit" else None,
    }
    if lm_drive == "jit":
        lm.clear_graphs()
    return row, res.state


def budget_gaps(post: dict, ref: dict, budget: dict) -> dict:
    """The JAX campaign's comparison of ``post`` with ``ref``
    (tests/test_flatline_parity.py:151-198): a row that lowers both the
    inlier error and the objective (``dominates``) is held only to an
    inlier-count deficit, any other to every budget. Returns dominates, the
    gaps and whether they are ``within`` the budget."""
    dominates = (post["inlier_mean_reprojection_error"]
                 <= ref["inlier_mean_reprojection_error"]
                 and post["true_objective"] <= ref["true_objective"])
    count_gap = (max(0, ref["n_inliers"] - post["n_inliers"]) if dominates
                 else abs(post["n_inliers"] - ref["n_inliers"]))
    gaps = {"inlier_px": abs(post["inlier_mean_reprojection_error"]
                             - ref["inlier_mean_reprojection_error"]),
            "obj_rtol": abs(post["true_objective"] - ref["true_objective"])
            / abs(ref["true_objective"]),
            "inlier_count_rtol": count_gap / ref["n_inliers"]}
    keys = ("inlier_count_rtol",) if dominates else tuple(budget)
    return {"dominates": dominates, "gaps": gaps,
            "within": all(gaps[k] < budget[k] for k in keys)}


def card() -> str:
    """The card as ``nvidia-smi`` names it, with its power limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=HERE, timeout=60,
                             capture_output=True, text=True, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def plan(problems, modes, drives) -> list:
    """The (problem key, mode, drive) rows to run, in order."""
    rows = []
    for key in problems:
        for drive in drives:
            if key == "ladybug" and drive not in LADYBUG_DRIVES:
                continue
            for mode in modes:
                if key == "ladybug" and mode not in LADYBUG_MODES:
                    continue
                rows.append((key, mode, drive))
    return rows


def row_key(row: dict) -> tuple:
    """(problem, mode, drive, LM drive) of a row; rows recorded before the
    jit drive existed ran the host drive."""
    return (row["problem"], row["mode"], row["drive"],
            row.get("lm_drive", "host"))


def merge_write(path: str, header: dict, rows: list) -> None:
    """Rewrite the artifact: ``header`` and the rows, replacing earlier rows
    with the same ``row_key``."""
    prev = {}
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
    seen = {row_key(r) for r in rows}
    merged = [r for r in prev.get("rows", []) if row_key(r) not in seen] + rows
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"header": header, "rows": merged}, f, indent=1)


def table(path: str) -> str:
    """The artifact as a markdown table, one line per row: status, LM
    iterations, wall seconds to the stop, LM it/s, peak GB, the post
    statistics, and the gaps (inlier px, objective relative; "dom" where
    the row dominates) to the scipy oracle's p16 flatline, else to the JAX
    campaign's row of the same problem, mode and drive."""
    with open(path) as f:
        data = json.load(f)
    oracle = {os.path.basename(PROBLEMS["p16"]): os.path.join(
        HERE, "benchmarks", "results", "cpu_p16_flatline.json")}
    with open(os.path.join(HERE, "benchmarks", "parity_campaign.json")) as f:
        jax_rows = {(r["problem"], r["mode"], r["drive"]): r
                    for r in json.load(f)["rows"]}
    lines = [f"Card: {data['header']['card']}; {data['header']['commit']}.", "",
             "| problem | drive | mode | status | iters | wall s | it/s | peak GB "
             "| inlier px | objective | inliers | vs | gap px | gap obj |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    order = {d: i for i, d in enumerate(DRIVES)}
    def key(r):  # by problem size, then drive, LM drive and mode
        size = r["post"]["n_observations"] if "post" in r else 0
        return (size, r["problem"], order[r["drive"]], r.get("lm_drive", "host"),
                MODES.index(r["mode"]))

    for r in sorted(data["rows"], key=key):
        drive = r["drive"] + (" jit" if r.get("lm_drive") == "jit" else "")
        if "post" not in r:
            lines.append(f"| {r['problem']} | {drive} | {r['mode']} | "
                         f"{r['status']} |" + " |" * 10)
            continue
        post = r["post"]
        if r["problem"] in oracle:
            with open(oracle[r["problem"]]) as f:
                ref, vs = json.load(f)["post"], "scipy"
        elif (r["problem"], r["mode"], r["drive"]) in jax_rows:
            ref, vs = jax_rows[(r["problem"], r["mode"], r["drive"])]["post"], "JAX"
        else:
            ref, vs = None, "-"
        gap = "| - | - |"
        if ref is not None:
            v = budget_gaps(post, ref, BUDGETS[r["drive"]])
            dom = " dom" if v["dominates"] else ""
            gap = (f"| {v['gaps']['inlier_px']:.2e}{dom} | "
                   f"{v['gaps']['obj_rtol']:.2e} |")
        status = {"Success (Energy Flatlined)": "flatline",
                  "Success (Exceeded Maximum Lambda)": "lambda-max"}.get(
                      r["status"], r["status"])
        peak = "-" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 1e9:.2f}"
        lines.append(
            f"| {r['problem'].split('-pre')[0]} | {drive} | {r['mode']} | "
            f"{status} | {r['iterations']} | {r['wall_s']:.3f} | "
            f"{r['it_per_s']:.2f} | {peak} | "
            f"{post['inlier_mean_reprojection_error']:.6f} | "
            f"{post['true_objective']:.2f} | {post['n_inliers']} | {vs} {gap}")
    return "\n".join(lines)


def run_subprocess(key, mode, drive, args, header) -> dict:
    """One row in a child process; CRASHED or TIMEOUT where it gives none."""
    name = LADYBUG_NAME if key == "ladybug" else os.path.basename(
        PROBLEMS.get(key, key))
    cmd = [sys.executable, os.path.abspath(__file__), "--one", key, mode, drive,
           "--max-iter", str(args.max_iter), "--lm-drive", args.lm_drive]
    if args.device:
        cmd += ["--device", args.device]
    t0 = time.perf_counter()
    failed = {"problem": name, "mode": mode, "drive": drive,
              "lm_drive": args.lm_drive, "card": header["card"]}
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                              timeout=args.timeout)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode("utf-8", "replace") if isinstance(
            e.stderr, bytes) else str(e.stderr or "")
        return {**failed, "status": "TIMEOUT",
                "wall_s": time.perf_counter() - t0, "stderr_tail": err[-2000:]}
    for line in proc.stdout.splitlines():
        if line.startswith(SENTINEL):
            return {**json.loads(line[len(SENTINEL):]), "card": header["card"]}
    return {**failed, "status": "CRASHED", "returncode": proc.returncode,
            "wall_s": time.perf_counter() - t0, "stderr_tail": proc.stderr[-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problems", default="p16,p126,p257,ladybug")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--drives", default=",".join(DRIVES))
    ap.add_argument("--lm-drive", default="host", choices=("host", "jit"),
                    help="the LM drive: the host loop or the device-resident "
                    "CUDA graph (default host)")
    ap.add_argument("--max-iter", type=int, default=2000)
    ap.add_argument("--json", default=ARTIFACT,
                    help="the artifact, relative to this file's directory")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="wall limit of one row (s)")
    ap.add_argument("--commit", default=None,
                    help="what the header names as the code's version "
                    "(default: git rev-parse HEAD)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    ap.add_argument("--one", nargs=3, metavar=("PROBLEM", "MODE", "DRIVE"),
                    help="run one row in this process and print it")
    ap.add_argument("--table", action="store_true",
                    help="print the artifact (--json) as a markdown table; run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(os.path.join(HERE, args.json)))
        return 0
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"flatline_campaign: {e}", file=sys.stderr)
        return 2

    if args.one:
        key, mode, drive = args.one
        problem, name = load_problem(key, device)
        row, _ = run_row(problem, name, mode, drive, args.max_iter, device,
                         args.lm_drive)
        print(SENTINEL + json.dumps(row), flush=True)
        return 0

    header = {"card": card() if device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "commit": args.commit or commit()}
    print(json.dumps({"header": header}), flush=True)
    out = os.path.join(HERE, args.json)
    rows, failed = [], 0
    for key, mode, drive in plan(args.problems.split(","), args.modes.split(","),
                                 args.drives.split(",")):
        row = run_subprocess(key, mode, drive, args, header)
        failed += row["status"] in ("CRASHED", "TIMEOUT")
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "trace"}),
              flush=True)
        merge_write(out, header, rows)
    print(f"wrote {len(rows)} rows to {args.json}; {failed} crashed or timed out",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

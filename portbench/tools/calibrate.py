"""Readings for a cell's limits: the comparison's numbers on many seeds of
the program and on a few of each control, read in one process per cell.

    python3 portbench/tools/calibrate.py --cells <cell>[,<cell>...]
        [--seeds 12] [--seconds 3] [--controls float32]
        [--control-seeds 3] [--control-seconds S] [--faults a,b]
        [--first-seed 2147483648]

For each cell: the program is set up once; each seed gets a window and
its step-by-step solve; then each control (``core/session.CONTROLS``)
and each planted fault (``core/faults.py``) is set up and read the same way on the control seeds; then, with the
program freed, the reference judges every run. One JSON line per run
(cell, side, seed, solves, every reading, each answer's and each followed
iteration's reference energies, the notes) on standard output and in
``chiprun_out/calibrate.jsonl``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from portbench.core import check, faults, registry, session  # noqa: E402


def read_side(cell, raw, dev, control, seeds, seconds, fault=None):
    undo = faults.plant(fault) if fault else None
    try:
        prog = session.Program(cell, raw, dev, control)
    except Exception:
        if undo:
            undo()
        raise
    out = []
    for seed in seeds:
        win = prog.window(seed, seconds)
        j = check.draw(seed, len(win.solves), "follow")
        steps = prog.follow(seed, j, session.FOLLOW_ITERATIONS)
        captures = sum(bool(s["captured"]) for s in win.solves) + prog.follow_captured
        out.append((fault or control or "program", seed, win, j, steps, captures))
    tol = prog.cfg.tol_fun
    info = {"capture_s": prog.capture_s, "mem_bytes": prog.mem}
    prog.close()
    if undo:
        undo()
    return out, tol, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", default=None,
                    help=f"comma list (default: {','.join(session.CONTROLS)})")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31)
    ap.add_argument("--faults", default="",
                    help=f"comma list of faults to read on the control seeds: {faults.FAULTS}")
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="window of the control and fault runs (default --seconds)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = registry.load_benchmark()
    os.makedirs(os.path.join(registry.ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(registry.ROOT, "chiprun_out", "calibrate.jsonl"), "a")
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    cseeds = [args.first_seed + 104729 + 7919 * i for i in range(args.control_seeds)]
    for name in args.cells.split(","):
        cell = registry.cell(bench, name)
        t0 = time.perf_counter()
        raw = session.raw_arrays(cell.config)
        runs, tol, info = [], 1e-8, {}
        if seeds:
            runs, tol, info = read_side(cell, raw, dev, None, seeds, args.seconds)
        info["total_s"] = time.perf_counter() - t0
        cs = args.control_seconds or args.seconds
        controls = (session.CONTROLS if args.controls is None
                    else list(filter(None, args.controls.split(","))))
        for control in controls:
            try:
                more, tol, _ = read_side(cell, raw, dev, control, cseeds, cs)
                runs += more
            except Exception as e:  # noqa: BLE001 - a control that crashes has failed
                print(json.dumps({"cell": name, "side": control, "error": repr(e)[:2000]}),
                      flush=True)
        for fault in filter(None, args.faults.split(",")):
            try:
                more, tol, _ = read_side(cell, raw, dev, None, cseeds, cs, fault)
                runs += more
            except Exception as e:  # noqa: BLE001 - a fault that crashes has failed
                print(json.dumps({"cell": name, "side": fault, "error": repr(e)[:2000]}),
                      flush=True)
        for side, seed, win, j, steps, captures in runs:
            t1 = time.perf_counter()
            v = session.judge(cell, raw, seed, win, j, steps, tol, captures, dev)
            line = {"cell": name, "side": side, "seed": seed,
                    "solves": len(win.solves), "window_s": win.seconds,
                    "iterations": [s["iterations"] for s in win.solves],
                    "stops": [s["stop"] for s in win.solves],
                    "slots": sum(s["slots"] for s in win.solves),
                    "failed": v["failed"], "readings": v["readings"],
                    "answers": v["solves"], "followed": v["iterations"],
                    "notes": v["notes"][:6], "judge_s": time.perf_counter() - t1,
                    **({"setup": info} if side == "program" and seed == seeds[0] else {})}
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

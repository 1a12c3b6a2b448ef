"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its metrics are found by name
from ``BENCHMARK.json`` (``portbench/core/registry.py``). Set-up loads or
generates the configuration's problem, builds the port's problem from
those arrays and runs one warm-up solve (it captures the CUDA graph; on a
checkout's first run the port's kernels are built into its ``_build/``).
The window then solves again and again from seeded start points, one
``lm.minimize`` after another (a closed loop of one client), and ends at
the end of the first solve that crosses ``--seconds``. With ``--trace 1``
``torch.profiler`` records the window's solves in groups of the cell's
``trace_solves``, from the first, until a group's trace holds every
chain-kernel launch the port counted (three groups at most, and no more
than the profiler records in one process), and the per-layer metrics are
read from that trace. After the
window the comparison with the float64 reference decides ``correct``
(``portbench/core/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (solves in the window), ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit, which also end standard error. The run exits 2
without a result where there is no CUDA device, fewer than the cell asks
for, or the port cannot be imported, and 3 where the process holds JAX or
the JAX package once the window has closed. It never falls back to the
CPU.
"""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "bundleadjustment_benchmarks_tpu")


def process_start() -> float:
    """This process's start on ``time.time()``'s clock, from /proc (Linux);
    the harness's import time where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return T_IMPORT


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(res: dict, bench: dict, traced: bool) -> dict:
    """The result line of a finished run (``session.run``'s dict)."""
    from portbench.core import registry, trace

    r, verdict = res["run"], res["verdict"]
    metrics = {}
    for entry, mod in registry.metrics(bench, r.cell.name, traced):
        value = mod.read(r)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": r.card, "count": r.cell.chips,
              "memory_peak_bytes": max(r.mem_bytes)}
    line = {"correct": verdict["correct"], "attempted": len(r.solves),
            "failed": verdict["failed"], "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = trace.busy_s(r.trace)
        device["window_s"] = r.trace.window_s
        # False where the profiler dropped kernels of the replayed graph
        # (fewer chain-kernel records than the port counted launches).
        device["trace_complete"] = r.trace_complete
        device["trace_tries"] = r.trace_tries
        device["trace_ops"] = len(r.trace.ops)
        line["breakdown"] = {"device_ops": trace.device_ops(r.trace),
                             "idle_gaps": trace.idle_gaps(r.trace)}
    limits = r.cell.spec["limits"]
    line["checks"] = {name: {"value": v, "limit": limits[name]}
                      for name, v in verdict["numbers"].items()}
    return line


def main(argv=None) -> int:
    t_process = process_start()
    # Build and kernel caches at fixed paths inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(HERE, ".cache", sub)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.core import registry

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import bundleadjustment_benchmarks_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port cannot be imported: {e}", file=sys.stderr)
        return 2
    from portbench.core import session

    res = session.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_process)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    line = result_line(res, bench, bool(args.trace))
    if args.trace and res["run"].trace_tries > 1:
        print(f"portbench: traced {res['run'].trace_tries} groups of solves; "
              f"the last complete: {res['run'].trace_complete}", file=sys.stderr)
    if args.trace and not res["run"].trace_complete:
        print("portbench: the trace holds fewer chain-kernel launches than the "
              "port counted: busy_s is a lower bound", file=sys.stderr)
    for note in res["verdict"]["notes"]:
        print(f"portbench: {note}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the port, with the JAX package's flags and output lines.

Reference: bundle_adjustment_large.cpp:40-176. Parse a BAL file, print the
pre-optimization statistics, run LM with the selected solver and time it,
print the post-optimization statistics. The reference's five binaries are
``--solver``; its compile-time Scalar typedef is ``--precision``/``--dtype``.

    python -m bundleadjustment_benchmarks_tpu_torch.cli problem.txt.gz \
        --solver cholesky --precision mixed

Runs on the current CUDA device; ``--device cpu`` runs on the CPU. Without
a CUDA device and without ``--device`` it refuses to run (return code 1).
``--shards N`` runs N local ranks of the sharded path, one per GPU (NCCL), or
on the CPU with ``--device cpu`` (gloo); rank 0 prints. ``--drive jit`` runs
the device-resident LM drive (``lm.DeviceLoop``), one device only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

RETURN_SUCCESS = 0
RETURN_WRONG_INPUT_PARAMS = 1
RETURN_WRONG_INPUT_FILE = 2

#: Reference constants (bundle_adjustment_large.cpp:35-36).
AVG_FOCAL_LENGTH = 1.0
INLIER_THRESHOLD = 0.5


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bundleadjustment_benchmarks_tpu_torch",
        description="Bundle adjustment benchmarks on BAL problems "
        "(PyTorch/CUDA).",
    )
    p.add_argument("problem", help="BAL sparse reconstruction file")
    p.add_argument(
        "--solver",
        default="cholesky",
        choices=["qrkit", "qrchol", "moreqr", "spqr", "cholesky"],
        help="inner linear solver strategy (the reference's five binaries)",
    )
    p.add_argument(
        "--dtype", default="f64", choices=["f32", "f64"],
        help="f64: everything float64; f32: the Schur matmuls in float32, "
        "state and geometry float64",
    )
    p.add_argument(
        "--geometry",
        default="state",
        choices=["state", "df32"],
        help="geometry arithmetic: 'state' = the state dtype; 'df32' = "
        "two-float float32 (float64-quality transform in float32 operations; "
        "on CUDA through the chain kernels)",
    )
    p.add_argument(
        "--precision",
        default=None,
        choices=["f64", "mixed", "f32"],
        help="preset overriding --dtype/--geometry: 'f64' = everything "
        "float64 (reference Scalar=double); 'mixed' = float64 state + df32 "
        "geometry + float32 Schur matmuls; 'f32' = a float32 state and "
        "float32 arithmetic (reference Scalar=float; the LM scalars stay "
        "Python floats)",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=0,
        help="shard the points over this many local ranks "
        "(torch.distributed): one per GPU (NCCL), or on the CPU with "
        "--device cpu (gloo); 0 = one device, no process group",
    )
    p.add_argument(
        "--drive",
        default="host",
        choices=["host", "jit"],
        help="'host': the Python LM loop, one host read per trial, true "
        "per-trial table rows; 'jit': the device-resident drive (on CUDA one "
        "captured CUDA graph with conditional nodes replayed per chunk of 16 "
        "iterations, the LM scalars read once per chunk; rejected table "
        "rows are synthesized, Elapsed is the chunk's average per trial). "
        "Not with --shards",
    )
    p.add_argument("--max-iters", type=int, default=1_000_000)
    p.add_argument(
        "--polish",
        type=int,
        default=0,
        metavar="N",
        help="after a fast-geometry drive (--geometry df32 / --precision "
        "mixed) stops, continue up to N iterations in full float64 from its "
        "final iterate (the two-phase drive). Ignored for pure-f64 runs",
    )
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--inlier-threshold", type=float, default=INLIER_THRESHOLD)
    p.add_argument("--quiet", action="store_true", help="suppress iteration table")
    p.add_argument(
        "--keep-final-step",
        action="store_true",
        help="disable the reference's discard-final-step-on-flatline quirk",
    )
    p.add_argument("--log-file", default="runtime_log.log")
    p.add_argument(
        "--profile-dir",
        default=None,
        help="write a torch.profiler Chrome trace (trace.json) of the "
        "optimization into this directory",
    )
    p.add_argument(
        "--checkpoint",
        default=None,
        help="checkpoint file: resumed from if it exists, written every "
        "--checkpoint-every iterations",
    )
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument(
        "--debug-nans",
        action="store_true",
        help="fail fast (FloatingPointError) at the first non-finite energy "
        "or rho denominator",
    )
    p.add_argument(
        "--metrics",
        default=None,
        help="append one JSONL record per trial to this file",
    )
    p.add_argument(
        "--device",
        default=None,
        help="torch device, e.g. 'cpu' or 'cuda:1' (default: the current CUDA "
        "device; there is no silent fall-back to the CPU)",
    )
    return p


def _precision(args):
    """(state dtype, geometry, matmul dtype) of the flags (JAX cli.py:158-174)."""
    import torch

    geometry = None if args.geometry == "state" else args.geometry
    if args.precision == "f32":
        return torch.float32, None, None
    if args.precision == "f64":
        return torch.float64, None, None
    if args.precision == "mixed":
        return torch.float64, "df32", "float32"
    return torch.float64, geometry, None if args.dtype == "f64" else "float32"


def _shard_devices(n: int, device):
    """One device per rank: the CPU for every rank, or GPUs 0..n-1 (the
    given one for a single rank); None, after a message, where the machine
    has fewer GPUs than ranks."""
    import torch

    if device.type == "cpu":
        return ["cpu"] * n
    if n == 1:
        return [str(device)]
    found = torch.cuda.device_count()
    if found < n:
        print(f"--shards {n} needs {n} CUDA devices, one per rank; found "
              f"{found} (--device cpu runs {n} ranks on the CPU)",
              file=sys.stderr)
        return None
    return [f"cuda:{i}" for i in range(n)]


def _run_and_report(args, problem, device, run, echo: bool = True):
    """The header and statistics, ``run()`` timed (and profiled with
    --profile-dir), its status and the statistics of its state; printed
    only where ``echo``."""
    import torch

    from bundleadjustment_benchmarks_tpu_torch.solvers import lm
    from bundleadjustment_benchmarks_tpu_torch.utils import stats

    def show(state):
        stats.show_error_statistics(
            state, problem.obs, AVG_FOCAL_LENGTH, args.inlier_threshold)
        stats.show_objective(
            state, problem.obs, AVG_FOCAL_LENGTH, args.inlier_threshold)

    def synchronized():
        result = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return result

    if echo:
        print(f"N(cameras) = {problem.n_cameras}, M(points) = {problem.n_points},"
              f" K(measurements) = {problem.n_observations}")
        show(problem.state)
    begin = time.perf_counter()
    if args.profile_dir and echo:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = synchronized()
        elapsed = time.perf_counter() - begin
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    else:
        result = synchronized()
        elapsed = time.perf_counter() - begin
    if echo:
        print(f"lm.minimize(params) ... {elapsed:g}s")
        print(f"LM finished with status: {lm.STATUS_STRINGS[result.status]}")
        show(result.state)


def _observe(args) -> dict:
    return dict(checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every if args.checkpoint else 0,
                metrics_path=args.metrics)


def _resume(args, dtype, echo: bool = True):
    """(state, meta) of --checkpoint where the file exists, else (None, None)."""
    from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint

    if not (args.checkpoint and os.path.exists(args.checkpoint)):
        return None, None
    state, meta = checkpoint.load_checkpoint(args.checkpoint, dtype=dtype,
                                             device="cpu")
    if echo:
        print(f"Resuming from {args.checkpoint} (iteration {meta['iteration']})")
    return state, meta


def _shard_rank(rank: int, device, args, problem, cfg, dtype) -> None:
    """One rank of ``--shards``: its shard of the problem (of the
    checkpoint's state when resuming), the sharded LM; rank 0 prints."""
    from bundleadjustment_benchmarks_tpu_torch.parallel import sharded

    echo = rank == 0

    def run():
        state, resume = _resume(args, dtype, echo)
        full = problem if state is None else dataclasses.replace(problem, state=state)
        sp = sharded.shard_problem(full, args.shards, rank, device=device)
        return sharded.minimize_sharded(sp, mode=args.solver, config=cfg,
                                        resume=resume, **_observe(args))

    shown = dataclasses.replace(problem, state=problem.state.to(device),
                                obs=problem.obs.to(device))
    _run_and_report(args, shown, device, run, echo)
    sys.stdout.flush()


def main(argv=None) -> int:
    args_list = sys.argv[1:] if argv is None else argv
    try:
        args = build_parser().parse_args(args_list)
    except SystemExit as e:
        return RETURN_WRONG_INPUT_PARAMS if e.code else RETURN_SUCCESS
    if args.shards < 0:
        print(f"--shards {args.shards}: give 0 (one device) or a number of "
              "ranks", file=sys.stderr)
        return RETURN_WRONG_INPUT_PARAMS
    if args.shards and args.drive == "jit":
        print("--drive jit has no sharded form yet (its all-reduces would "
              "have to be captured into the CUDA graph); use --drive host "
              "with --shards", file=sys.stderr)
        return RETURN_WRONG_INPUT_PARAMS

    from bundleadjustment_benchmarks_tpu_torch import resolve_device
    from bundleadjustment_benchmarks_tpu_torch.models.problem import load_bal_problem
    from bundleadjustment_benchmarks_tpu_torch.parallel import multihost
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm
    from bundleadjustment_benchmarks_tpu_torch.utils import logger

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"--device {args.device}: {e}" if args.device else
              "no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return RETURN_WRONG_INPUT_PARAMS
    devices = _shard_devices(args.shards, device) if args.shards else None
    if args.shards and devices is None:
        return RETURN_WRONG_INPUT_PARAMS
    state_dtype, geometry, matmul_dtype = _precision(args)

    log = logger.create_logger(args.log_file)
    log.log(logger.INFO, "Computation STARTED!")

    try:
        # Sharded runs load on the CPU; each rank moves its shard.
        problem = load_bal_problem(
            args.problem,
            dtype=state_dtype,
            inlier_threshold=args.inlier_threshold,
            avg_focal_length=AVG_FOCAL_LENGTH,
            device="cpu" if args.shards else device,
        )
    except (OSError, ValueError) as e:
        print(f"Cannot open {args.problem}: {e}", file=sys.stderr)
        return RETURN_WRONG_INPUT_FILE

    cfg = lm.LMConfig(
        tol_fun=args.tol,
        max_iter=args.max_iters,
        verbose=not args.quiet,
        discard_final_step=not args.keep_final_step,
        matmul_dtype=matmul_dtype,
        geometry=geometry,
        polish_iters=args.polish,
        debug_nans=args.debug_nans,
        drive=args.drive,
    )

    if args.shards:
        multihost.run_ranks(_shard_rank, devices,
                            args=(args, problem, cfg, state_dtype))
    else:
        def run():
            state, resume = _resume(args, state_dtype)
            return lm.minimize(problem, mode=args.solver, config=cfg,
                               state=state, device=device, resume=resume,
                               **_observe(args))

        _run_and_report(args, problem, device, run)

    log.log(logger.INFO, "Computation DONE!")
    return RETURN_SUCCESS


if __name__ == "__main__":
    sys.exit(main())

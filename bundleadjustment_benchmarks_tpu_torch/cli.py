"""Command line of the port, with the JAX package's flags and output lines.

Reference: bundle_adjustment_large.cpp:40-176. Parse a BAL file, print the
pre-optimization statistics, run LM with the selected solver and time it,
print the post-optimization statistics. The reference's five binaries are
``--solver``; its compile-time Scalar typedef is ``--precision``/``--dtype``.

    python -m bundleadjustment_benchmarks_tpu_torch.cli problem.txt.gz \
        --solver cholesky --precision mixed

Runs on the current CUDA device; ``--device cpu`` runs on the CPU. Without
a CUDA device and without ``--device`` it refuses to run (return code 1).
"""

from __future__ import annotations

import argparse
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
        help="shard the problem over this many devices: not ported yet "
        "(any value above 0 is refused); 0 = one device",
    )
    p.add_argument(
        "--drive",
        default="host",
        choices=["host", "jit"],
        help="accepted for the JAX package's command lines; both values run "
        "the one loop, which returns to the host on every trial and prints "
        "the iteration table",
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


def main(argv=None) -> int:
    args_list = sys.argv[1:] if argv is None else argv
    try:
        args = build_parser().parse_args(args_list)
    except SystemExit as e:
        return RETURN_WRONG_INPUT_PARAMS if e.code else RETURN_SUCCESS
    if args.shards:
        print(f"--shards {args.shards}: the distributed path is not ported "
              "yet; run without --shards", file=sys.stderr)
        return RETURN_WRONG_INPUT_PARAMS

    import torch

    from bundleadjustment_benchmarks_tpu_torch import resolve_device
    from bundleadjustment_benchmarks_tpu_torch.models.problem import load_bal_problem
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm
    from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint, logger, stats

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"--device {args.device}: {e}" if args.device else
              "no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return RETURN_WRONG_INPUT_PARAMS
    state_dtype, geometry, matmul_dtype = _precision(args)

    log = logger.create_logger(args.log_file)
    log.log(logger.INFO, "Computation STARTED!")

    try:
        problem = load_bal_problem(
            args.problem,
            dtype=state_dtype,
            inlier_threshold=args.inlier_threshold,
            avg_focal_length=AVG_FOCAL_LENGTH,
            device=device,
        )
    except (OSError, ValueError) as e:
        print(f"Cannot open {args.problem}: {e}", file=sys.stderr)
        return RETURN_WRONG_INPUT_FILE

    print(
        f"N(cameras) = {problem.n_cameras}, M(points) = {problem.n_points},"
        f" K(measurements) = {problem.n_observations}"
    )

    stats.show_error_statistics(
        problem.state, problem.obs, AVG_FOCAL_LENGTH, args.inlier_threshold
    )
    stats.show_objective(
        problem.state, problem.obs, AVG_FOCAL_LENGTH, args.inlier_threshold
    )

    cfg = lm.LMConfig(
        tol_fun=args.tol,
        max_iter=args.max_iters,
        verbose=not args.quiet,
        discard_final_step=not args.keep_final_step,
        matmul_dtype=matmul_dtype,
        geometry=geometry,
        polish_iters=args.polish,
        debug_nans=args.debug_nans,
    )

    def run():
        state, resume = problem.state, None
        if args.checkpoint and os.path.exists(args.checkpoint):
            state, resume = checkpoint.load_checkpoint(
                args.checkpoint, dtype=state_dtype, device=device)
            print(f"Resuming from {args.checkpoint} "
                  f"(iteration {resume['iteration']})")
        result = lm.minimize(
            problem, mode=args.solver, config=cfg, state=state, device=device,
            resume=resume, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every if args.checkpoint else 0,
            metrics_path=args.metrics,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return result

    begin = time.perf_counter()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = run()
        elapsed = time.perf_counter() - begin
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    else:
        result = run()
        elapsed = time.perf_counter() - begin
    print(f"lm.minimize(params) ... {elapsed:g}s")
    print(f"LM finished with status: {lm.STATUS_STRINGS[result.status]}")

    stats.show_error_statistics(
        result.state, problem.obs, AVG_FOCAL_LENGTH, args.inlier_threshold
    )
    stats.show_objective(
        result.state, problem.obs, AVG_FOCAL_LENGTH, args.inlier_threshold
    )

    log.log(logger.INFO, "Computation DONE!")
    return RETURN_SUCCESS


if __name__ == "__main__":
    sys.exit(main())

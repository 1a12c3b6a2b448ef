"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the chain kernels from ``bundleadjustment_benchmarks_tpu_torch/ops/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
in-repo BAL stand-ins, drives ``lm.minimize(mode="cholesky")`` on the df32
drive (kernels on, p257 stand-in) and on the float64 drive (p16 stand-in),
then the other four solver modes (``modes_df32_p257``, ``modes_f64_p16``),
every solve realization against cholesky's step (``modes_agree_p16``),
qrkit's "rows" and "pair" forms (``qrkit_forms_p257``) and spqr's "gram"
and "tsqr" forms (``spqr_forms_p257``), then the command line in-process
(``cli.main``): p257 with ``--precision mixed``, a checkpoint and its resume
(``cli_mixed_p257``), p16 in float64 with every solver and a two-phase
``--polish`` run (``cli_f64_p16``), and a generated stand-in of BAL's
Ladybug problem-1723-156502 whose 1,723 cameras the kernels do not stage in
shared memory (``cli_ladybug_df32``), then the sharded path
(``parallel/sharded.py``): NCCL at world size 1 against one device on p257
(``sharded_nccl_p257``), 2 and 4 gloo ranks sharing the card on p257, every
mode at 2 ranks on p257 df32 and on p16 float64 (``sharded_gloo_p257``,
``sharded_f64_p16``), 2 ranks on the Ladybug stand-in
(``sharded_ladybug_df32``), a checkpoint written at 2 ranks resumed on one
device, the command line's ``--shards`` (``cli_shards``) and the dry run at
1 and 2 ranks (``dryrun_multichip``), then every mode on p16 float64 to the
reference's flatline stop, each held to the JAX campaign's f64 budget
against the scipy oracle (``flatline_p16_f64``), the ellipse-fitting example
on the card (``ellipse``) and the blocked Cholesky pair against cuSOLVER's
at the p257 and Ladybug reduced-system sizes (``blocked_chol``), then the
device-resident LM drive (``drive="jit"``): both kernels replayed from a
captured graph (``jit_kernels_replayed``), p257 df32 cholesky on both
drives alternated (``jit_p257_df32``), the chunk loop with no
synchronization between its reads (``jit_no_sync``), every mode
(``jit_modes``) and the Ladybug stand-in (``jit_ladybug_df32``), and fails
on any disagreement. ``--jit-only`` runs the build and the jit phases
alone.
Each phase prints JSON lines with its wall time; then come one line of
per-kernel numbers (the kernel's and its entry point's device
time, the host time to issue one call, the device operations one call
issues, which must be 1, and the launch shape), and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a CUDA device,
or without the package beside it, it exits non-zero before printing any
result. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gzip
import hashlib
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
PACKAGE = HERE / "bundleadjustment_benchmarks_tpu_torch"
P16 = HERE / "data" / "problem-16-22106-pre.txt.gz"
P257 = HERE / "data" / "problem-257-65132-pre.txt.gz"

#: Published device-memory rate (bytes/s) and float32 peak (FLOP/s, outside
#: the tensor cores, an FMA counted as two) by card name (NVIDIA data sheets).
CARDS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
)
#: float32 instructions per observation, counted from csrc/chain_math.cuh
#: (two_prod = mul + fma; df_mul 9, df_add 11). Built with --fmad=false, they
#: issue as separate adds and multiplies (two_prod's one fma counts once), at
#: half the FMA-counting peak (SMs x 128 lanes x clock). The DF transform
#: 180, the residual 18, the robust factor 12; blocks then add the Jacobian
#: rows and the robust product (166) and the DF square sum (15), energy adds
#: its DF square (15); each adds one DF add into its running sum (11). The
#: camera split into DF halves is per camera (N-sized) and is not counted.
OPS_PER_OBS = {"chain_blocks": 180 + 18 + 12 + 166 + 15 + 11,
               "chain_energy": 180 + 18 + 12 + 15 + 11}
#: The kernel rows must equal the plain version's bit for bit: both round
#: every operation alike (no contraction, IEEE division and square root).
ENERGY_RTOL = 1e-12  # DF trees of different shapes sum in different orders


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str):
    for key, bw, fp32 in CARDS:
        if key in name:
            return bw, fp32
    raise SystemExit(f"chip_smoke: no published rates for card {name!r}")


def time_ms(fn, reps: int, sleep_cycles: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` by CUDA events, cold L2: before each rep
    a buffer larger than L2 is rewritten and the stream is held busy
    (``torch.cuda._sleep``) while the host queues the rep, so the events
    time the device work and not the host's launch overhead."""
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_us(fn, calls: int = 100) -> float:
    """Median host time (µs) to issue one call of ``fn``, with no
    synchronize inside the timing; the stream is drained every 10 calls,
    outside it, so the launch queue never fills."""
    times = []
    for i in range(calls):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def device_ops_per_call(fn, profiles: int = 3) -> dict:
    """Device kernels and memory operations one call of ``fn`` issues, as
    ``torch.profiler`` records them in each of ``profiles`` profiles (after
    a warm-up call): ``kernels_per_call``, the count the profiles that
    recorded any device activity agree on (None where they disagree or
    none did), and ``empty_profiles``, how many recorded none. On the H100
    one profile of ``fused_energy`` came back empty in one full run of this
    script, though the call's kernel ran (its energy was checked), and the
    cause is not known; the gate allows one empty profile in three."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.device_type == DeviceType.CUDA
                          for e in prof.events()))
    seen = {c for c in counts if c}
    return {"kernels_per_call": seen.pop() if len(seen) == 1 else None,
            "empty_profiles": counts.count(0)}


def time_entry_points(cuda_chain, fast, obs, tau2, flush) -> dict:
    """Per kernel: ``ms``, the kernel alone (``launch`` on operands built
    beforehand); ``entry_ms``, the entry point a caller uses
    (``fused_blocks_energy`` / ``fused_energy`` on a FastBAState), both by
    ``time_ms``; ``host_us`` of the entry point; ``kernels_per_call``, the
    device operations one entry-point call issues, and ``empty_profiles``
    (``device_ops_per_call``)."""
    sleep = int(2e7)  # ~10 ms: longer than the host's enqueue
    ops = cuda_chain.chain_operands(fast, obs)
    entry = {"chain_blocks": lambda: cuda_chain.fused_blocks_energy(fast, obs, tau2),
             "chain_energy": lambda: cuda_chain.fused_energy(fast, obs, tau2)}
    out = {}
    for which, fn in entry.items():
        out[which] = {
            "ms": time_ms(lambda: cuda_chain.launch(which, ops, tau2), 20,
                          sleep, flush),
            "entry_ms": time_ms(fn, 20, sleep, flush),
            "host_us": host_us(fn),
            **device_ops_per_call(fn),
        }
    return out


def stage_ms(lm, prob, mode, x, lam, df32: bool, reps: int):
    """Medians (ms) of ``reps`` prepares and of ``reps`` trials at loop
    state ``x`` (a FastBAState on the df32 drive) and ``lam``, each ending
    in a synchronize."""
    times = {"prepare": [], "trial": []}
    for _ in range(reps):
        t = time.perf_counter()
        if df32:
            ctx, _, _ = lm._prepare_fast(x, prob, mode, "float32", kernels=True)
        else:
            ctx, _, _ = lm._prepare(x, prob, mode)
        torch.cuda.synchronize()
        times["prepare"].append(time.perf_counter() - t)
        t = time.perf_counter()
        if df32:
            lm._trial_fast(ctx, x, lam, prob, mode, "float32", kernels=True)
        else:
            lm._trial(ctx, x, lam, prob, mode)
        torch.cuda.synchronize()
        times["trial"].append(time.perf_counter() - t)
    return {f"{k}_ms_median": statistics.median(v) * 1e3 for k, v in times.items()}


def drive_mode(pm, lm, cuda_chain, prob, mode: str, max_iter: int,
               df32: bool, reps: int) -> tuple:
    """``lm.minimize(mode)`` after a one-iteration warm-up, timed, with the
    chain kernels' launches and the peak device memory of the run, then the
    stage medians at its final state and lambda. Returns (line, result)."""
    kw = dict(matmul_dtype="float32", geometry="df32") if df32 else {}
    lm.minimize(prob, mode=mode, config=lm.LMConfig(max_iter=1, **kw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_chain.reset_launches()
    t0 = time.perf_counter()
    res = lm.minimize(prob, mode=mode, config=lm.LMConfig(max_iter=max_iter, **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    line = {"mode": mode, "iterations": res.iterations,
            "fun_evals": res.fun_evals, "status": res.status.name,
            "final_energy": res.energy, "wall_s": wall,
            "lm_iter_per_s": res.iterations / wall,
            "launches": dict(cuda_chain.LAUNCHES),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    x = pm.to_fast(res.state) if df32 else res.state
    line.update(stage_ms(lm, prob, mode, x, res.lam, df32, reps))
    return line, res


#: Realizations of the damped solve: (mode, form). qrkit runs "pair" with
#: pair tables and "rows" without; spqr runs "gram". qrkit "gram" and spqr
#: "tsqr" are the parity tests' reference (``schur._reference_step``).
REALIZATIONS = (("cholesky", None), ("qrchol", None), ("moreqr", None),
                ("qrkit", "rows"), ("qrkit", "gram"), ("qrkit", "pair"),
                ("spqr", "gram"), ("spqr", "tsqr"))
#: modes_agree_p16: every realization's float64 step within this relative
#: gap of cholesky's, at lambda = AGREE_LAMBDA_FACTOR x cholesky's initial
#: lambda (well damped; measured on the CPU: <= 8.4e-9, moreqr's eigenbasis
#: back-substitution the widest).
AGREE_LAMBDA_FACTOR = 1e4
AGREE_RTOL = 1e-7


def no_pairs(prob):
    """The problem without its pair tables: qrkit then caches dense rows."""
    return dataclasses.replace(prob, pairs=None)


def realization_context(schur, blocks, prob, mode, form):
    if mode == "qrkit" and form in ("rows", "gram"):
        prob = no_pairs(prob)
    return schur.build_context(blocks, prob, mode), prob


def realization_step(schur, ctx, prob, mode, form, lam):
    """(dxp, dxc) of one realization: qrkit "gram" and spqr "tsqr" by the
    reference, the rest by ``solve_damped``."""
    if (mode, form) in (("qrkit", "gram"), ("spqr", "tsqr")):
        return schur._reference_step(ctx, lam, prob, mode)
    return schur.solve_damped(ctx, lam, prob, mode)


def modes_phases(pm, lm, schur, jacobian, cuda_chain, problems, smi) -> None:
    """The solver modes on the card: qrchol, moreqr, qrkit and spqr on the
    p257 df32 drive with the kernels; all five on p16 float64; every
    realization's step against cholesky's on one p16 context; qrkit's
    "rows" and "pair" trial times and peak memory on p257, both drives;
    spqr's "gram" and "tsqr" camera steps on p257 df32."""
    p257, p16 = problems["p257"], problems["p16"]
    t_phase = time.perf_counter()
    e0 = cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs, p257.tau2).item()
    lines = []
    for mode in ("qrchol", "moreqr", "qrkit", "spqr"):
        line, res = drive_mode(pm, lm, cuda_chain, p257, mode, max_iter=5,
                               df32=True, reps=5)
        line["initial_energy"] = e0
        lines.append(line)
        emit({"phase": "modes_df32_p257", **line, "nvidia_smi": smi})
        pts = res.state.points
        check(np.isfinite(res.energy) and res.energy < e0,
              f"{mode} df32 p257: energy {res.energy} not finite and below {e0}")
        check(bool(torch.isfinite(pts).all()), f"{mode} df32 p257: points not finite")
        for which in ("chain_blocks", "chain_energy"):
            check(line["launches"][which] > 0,
                  f"{mode} df32 p257: {which} was not launched")
    emit({"phase": "modes_df32_p257_done", "phase_s": time.perf_counter() - t_phase})

    t_phase = time.perf_counter()
    e0 = float(lm._prepare(p16.state, p16, "cholesky")[1])
    for mode in ("cholesky", "qrchol", "moreqr", "qrkit", "spqr"):
        line, res = drive_mode(pm, lm, cuda_chain, p16, mode, max_iter=10,
                               df32=False, reps=5)
        emit({"phase": "modes_f64_p16", **line, "initial_energy": e0,
              "nvidia_smi": smi})
        check(np.isfinite(res.energy) and res.energy < e0,
              f"{mode} f64 p16: energy {res.energy} not finite and below {e0}")
    emit({"phase": "modes_f64_p16_done", "phase_s": time.perf_counter() - t_phase})

    t_phase = time.perf_counter()
    blocks = jacobian.residuals_and_jacobian(p16.state, p16.obs, p16.tau2)
    steps, gaps, lam = {}, {}, None
    for mode, form in REALIZATIONS:
        ctx, prob = realization_context(schur, blocks, p16, mode, form)
        if lam is None:
            lam = AGREE_LAMBDA_FACTOR * float(schur.initial_lambda(ctx, "cholesky"))
        dxp, dxc = realization_step(schur, ctx, prob, mode, form, lam)
        name = mode if form is None else f"{mode}-{form}"
        steps[name] = torch.cat([dxp.reshape(-1), dxc.reshape(-1)])
        ref = steps["cholesky"]
        gaps[name] = ((steps[name] - ref).abs().max() / ref.abs().max()).item()
    emit({"phase": "modes_agree_p16", "lambda": lam,
          "lambda_rule": f"{AGREE_LAMBDA_FACTOR:g} x cholesky initial_lambda",
          "rel_gap_to_cholesky": gaps, "tolerance": AGREE_RTOL,
          "phase_s": time.perf_counter() - t_phase})
    for name, gap in gaps.items():
        check(np.isfinite(gap) and gap <= AGREE_RTOL,
              f"modes_agree_p16: {name} step {gap} from cholesky's")
    del ctx, steps

    t_phase = time.perf_counter()
    for df32 in (True, False):
        for form, prob in (("rows", no_pairs(p257)), ("pair", p257)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            x = pm.to_fast(prob.state) if df32 else prob.state
            if df32:
                _, _, lam0 = lm._prepare_fast(x, prob, "qrkit", "float32",
                                              kernels=True)
            else:
                _, _, lam0 = lm._prepare(x, prob, "qrkit")
            line = stage_ms(lm, prob, "qrkit", x, float(lam0), df32, reps=5)
            emit({"phase": "qrkit_forms_p257", "drive": "df32" if df32 else "f64",
                  "form": form, "lambda": float(lam0), **line,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "nvidia_smi": smi})
    emit({"phase": "qrkit_forms_p257_done", "phase_s": time.perf_counter() - t_phase})

    # spqr's camera step at p257 df32, the loaded state and spqr's initial
    # lambda (rounded to float32 as the trial rounds it): "gram", the path
    # the port runs, against the Householder TSQR it replaced.
    t_phase = time.perf_counter()
    ctx, _, lam0 = lm._prepare_fast(pm.to_fast(p257.state), p257, "spqr",
                                    "float32", kernels=True)
    lam = float(torch.tensor(float(lam0), dtype=torch.float32))
    Linv = schur._point_factor_inv(ctx, lam, "spqr", ctx.U.dtype)
    steps = {}
    for form, reps in (("gram", 5), ("tsqr", 3)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            if form == "gram":
                dxc = schur.camera_solve_qr(ctx, lam, p257)
            else:
                dxc = schur._camera_solve_tsqr(ctx, lam, p257, Linv,
                                               mm_dtype=torch.float32)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        steps[form] = dxc.double()
        emit({"phase": "spqr_forms_p257", "drive": "df32", "form": form,
              "lambda": lam, "camera_step_ms": [v * 1e3 for v in times],
              "camera_step_ms_median": statistics.median(times) * 1e3,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "nvidia_smi": smi})
    gap = ((steps["gram"] - steps["tsqr"]).abs().max()
           / steps["tsqr"].abs().max()).item()
    emit({"phase": "spqr_forms_p257_done", "camera_step_rel_gap": gap,
          "phase_s": time.perf_counter() - t_phase})
    check(np.isfinite(gap), "spqr_forms_p257: camera steps not finite")


#: BAL's Ladybug problem-1723-156502-pre (N, M, K): its stand-in is
#: generated with these N and M and mean point degree K / M.
LADYBUG = (1723, 156502, 678718)
CLI_ROW = re.compile(r"^\s*(\d+)\s+(Accepted|Rejected)\s")


def run_cli(cli, args) -> tuple:
    """``cli.main(args)`` in this process; returns (return code, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in args])
    return rc, buf.getvalue()


def cli_summary(out: str, metrics: Path) -> dict:
    """What a CLI run printed: header, pre and post "True objective", LM
    seconds and status, iteration-table rows, and its JSONL records.
    ``lm_iter_per_s`` is the iterations that ran a trial over the printed
    LM time (the iteration that only finds the limit is not counted)."""
    lines = out.splitlines()
    objective = [float(ln.split()[-1]) for ln in lines
                 if ln.startswith("True objective:")]
    lm_s = float(next(ln for ln in lines
                      if ln.startswith("lm.minimize(params)")).split()[-1][:-1])
    rows = [int(m[1]) for m in map(CLI_ROW.match, lines) if m]
    records = ([json.loads(ln) for ln in metrics.read_text().splitlines()]
               if metrics.exists() else [])
    iterations = len({(r.get("phase"), r["iter"]) for r in records})
    return {"header": lines[0], "objective_pre": objective[0],
            "objective_post": objective[-1], "lm_s": lm_s,
            "status": next(ln.split(": ", 1)[1] for ln in lines
                           if ln.startswith("LM finished with status")),
            "table_rows": len(rows), "first_row_iter": rows[0] if rows else None,
            "records": len(records), "iterations_run": iterations,
            "lm_iter_per_s": iterations / lm_s,
            "resumed": any(ln.startswith("Resuming from") for ln in lines)}


def kernel_bounds(n: int, m: int, k_obs: int, bw: float, op_rate: float) -> dict:
    """Per kernel (bound_ms, bound_by): each input read once, each output
    written once (the float64 cameras R, T, K(0, 0), k1, k2; the DF points,
    every point observed; the measurements and both indices; the energy,
    and the rows), and OPS_PER_OBS float32 instructions per observation."""
    inputs = 8 * 15 * n + 4 * (6 * m + 2 * k_obs + 2 * k_obs)
    out = {}
    for which, outputs in (("chain_blocks", 8 + 4 * 26 * k_obs),
                           ("chain_energy", 8)):
        t_bytes = (inputs + outputs) / bw * 1e3
        t_ops = OPS_PER_OBS[which] * k_obs / op_rate * 1e3
        out[which] = (max(t_bytes, t_ops),
                      "bytes" if t_bytes >= t_ops else "operations")
    return out


def cli_phases(cli, pm, bal, balgen, checkpoint, cuda_chain, smi, flush,
               bw, op_rate, ladybug) -> dict:
    """The command line on the card, in-process, its log, metrics and
    checkpoints in a temporary directory. Each run's chain-kernel launches
    are counted from 0. ``ladybug`` is the generated stand-in's
    (BalDataset, seconds to generate). Returns per kernel the CLI phases'
    launch counts and the Ladybug stand-in's kernel numbers."""
    extra = {"chain_blocks": {}, "chain_energy": {}}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        log = ["--log-file", tmp / "run.log"]

        # -- p257, mixed: 10 iterations, checkpoint every 5, then resume; the
        # same 10 iterations without the table and the checkpoints, and with
        # the table alone; then one checkpoint of the p257 state timed alone --
        t_phase = time.perf_counter()
        ck = tmp / "p257.ckpt.npz"
        base = [P257, "--precision", "mixed", "--solver", "cholesky"] + log
        ckpt = ["--checkpoint", ck, "--checkpoint-every", 5]
        runs = {}
        for name, args in (("first", ckpt + ["--max-iters", 10]),
                           ("resume", ckpt + ["--max-iters", 12]),
                           ("no_checkpoint", ["--quiet", "--max-iters", 10]),
                           ("table", ["--max-iters", 10])):
            metrics = tmp / f"p257_{name}.jsonl"
            cuda_chain.reset_launches()
            rc, out = run_cli(cli, base + args + ["--metrics", metrics])
            launches = dict(cuda_chain.LAUNCHES)
            check(rc == cli.RETURN_SUCCESS, f"cli_mixed_p257 {name}: rc {rc}")
            line = {"run": name, "args": " ".join(map(str, args)),
                    **cli_summary(out, metrics), "launches": launches}
            if name == "first":
                check(ck.exists(), "cli_mixed_p257: no checkpoint written")
                _, meta = checkpoint.load_checkpoint(str(ck), device="cuda")
                line["checkpoint"] = {k: meta[k] for k in ("iteration", "fun_evals")}
            runs[name] = line
            emit({"phase": "cli_mixed_p257", **line, "nvidia_smi": smi,
                  "phase_s": time.perf_counter() - t_phase})
        first, resume = runs["first"], runs["resume"]
        meta = first["checkpoint"]
        state, saved = checkpoint.load_checkpoint(str(ck), device="cuda")
        saved.pop("extra")
        copy_s, save_s = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in ("K", "R", "T", "k1", "k2", "points"):
                getattr(state, k).cpu()
            copy_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(str(tmp / "timed.npz"), state, **saved)
            save_s.append(time.perf_counter() - t0)
        emit({"phase": "cli_mixed_p257", "run": "save_checkpoint",
              "copy_s": sorted(copy_s), "save_s": sorted(save_s),
              "bytes": (tmp / "timed.npz").stat().st_size, "nvidia_smi": smi,
              "phase_s": time.perf_counter() - t_phase})
        check(first["header"] == "N(cameras) = 257, M(points) = 65132, "
              "K(measurements) = 238476", f"cli_mixed_p257: header {first['header']!r}")
        check(first["objective_post"] < first["objective_pre"],
              "cli_mixed_p257: the true objective did not descend")
        check(meta["iteration"] == 10,
              f"cli_mixed_p257: checkpoint at iteration {meta['iteration']}, not 10")
        check(first["records"] == meta["fun_evals"] - meta["iteration"]
              == first["launches"]["chain_energy"],
              "cli_mixed_p257: metrics records != fun_evals - prepares "
              "!= energy launches")
        check(first["launches"]["chain_blocks"] == meta["iteration"],
              "cli_mixed_p257: blocks launches != prepares")
        check(resume["resumed"] and resume["first_row_iter"] == meta["iteration"] + 1,
              f"cli_mixed_p257: resume began at {resume['first_row_iter']}")
        for run in runs.values():
            for which, count in run["launches"].items():
                check(count > 0, f"cli_mixed_p257 {run['run']}: {which} not launched")
        for which in extra:
            extra[which]["launches_cli_mixed_p257"] = first["launches"][which]

        # -- p16 as plain text, float64, every solver; a two-phase run ----------
        t_phase = time.perf_counter()
        p16_txt = tmp / "problem-16-22106-pre.txt"
        with gzip.open(P16, "rb") as src, open(p16_txt, "wb") as dst:
            shutil.copyfileobj(src, dst)
        tokenizer = "native" if bal._native_lib() is not None else "numpy"
        for solver in ("cholesky", "qrchol", "moreqr", "qrkit", "spqr"):
            metrics = tmp / f"p16_{solver}.jsonl"
            rc, out = run_cli(cli, [p16_txt, "--solver", solver, "--precision",
                                    "f64", "--max-iters", 3, "--quiet",
                                    "--metrics", metrics] + log)
            check(rc == cli.RETURN_SUCCESS, f"cli_f64_p16 {solver}: rc {rc}")
            line = cli_summary(out, metrics)
            emit({"phase": "cli_f64_p16", "solver": solver, "tokenizer": tokenizer,
                  **line, "nvidia_smi": smi,
                  "phase_s": time.perf_counter() - t_phase})
            check(line["objective_post"] < line["objective_pre"],
                  f"cli_f64_p16 {solver}: the true objective did not descend")
        metrics = tmp / "p16_polish.jsonl"
        cuda_chain.reset_launches()
        rc, out = run_cli(cli, [p16_txt, "--precision", "mixed", "--polish", 3,
                                "--max-iters", 10, "--quiet", "--metrics",
                                metrics] + log)
        launches = dict(cuda_chain.LAUNCHES)
        check(rc == cli.RETURN_SUCCESS, f"cli_f64_p16 polish: rc {rc}")
        line = cli_summary(out, metrics)
        phases = [json.loads(ln).get("phase")
                  for ln in metrics.read_text().splitlines()]
        emit({"phase": "cli_f64_p16", "solver": "cholesky", "polish": 3, **line,
              "records_by_phase": {p: phases.count(p) for p in ("fast", "polish")},
              "launches": launches, "nvidia_smi": smi,
              "phase_s": time.perf_counter() - t_phase})
        check(line["objective_post"] < line["objective_pre"],
              "cli_f64_p16 polish: the true objective did not descend")
        check(phases and phases[0] == "fast" and phases[-1] == "polish"
              and phases == sorted(phases),
              "cli_f64_p16 polish: records not tagged fast, then polish")
        check(all(c > 0 for c in launches.values()),
              "cli_f64_p16 polish: the fast phase did not launch both kernels")

        # -- Ladybug stand-in, mixed: cameras past the shared-memory stage ------
        t_phase = time.perf_counter()
        n, m, _ = LADYBUG
        ds, gen_s = ladybug
        path = tmp / "problem-1723-156502-pre-standin.txt.gz"
        t0 = time.perf_counter()
        balgen.write_bal_gz(str(path), ds)
        write_s = time.perf_counter() - t0
        k_obs = ds.n_observations
        shape = cuda_chain.launch_shape("chain_blocks", n, k_obs)
        check(not shape["staged_cameras"],
              "cli_ladybug_df32: the kernels stage 1,723 cameras")
        metrics = tmp / "ladybug.jsonl"
        torch.cuda.reset_peak_memory_stats()
        cuda_chain.reset_launches()
        rc, out = run_cli(cli, [path, "--precision", "mixed", "--max-iters", 3,
                                "--metrics", metrics] + log)
        launches = dict(cuda_chain.LAUNCHES)
        check(rc == cli.RETURN_SUCCESS, f"cli_ladybug_df32: rc {rc}")
        line = cli_summary(out, metrics)
        line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        check(line["header"] == f"N(cameras) = {n}, M(points) = {m}, "
              f"K(measurements) = {k_obs}", f"cli_ladybug_df32: {line['header']!r}")
        check(line["objective_post"] < line["objective_pre"],
              "cli_ladybug_df32: the true objective did not descend")
        for which, count in launches.items():
            check(count > 0, f"cli_ladybug_df32: {which} not launched")
            extra[which]["launches_cli_ladybug_df32"] = count

        # Both kernels at this K against their plain versions, and timed.
        prob = pm.load_bal_problem(str(path), device="cuda")
        fast = pm.to_fast(prob.state)
        ops = cuda_chain.chain_operands(fast, prob.obs)
        rows_k, eb_k = cuda_chain.launch("chain_blocks", ops, prob.tau2)
        rows_p, eb_p = cuda_chain.chain_blocks_plain(fast, prob.obs, prob.tau2)
        _, ee_k = cuda_chain.launch("chain_energy", ops, prob.tau2)
        ee_p = cuda_chain.fused_energy_plain(fast, prob.obs, prob.tau2)
        errs = {"chain_blocks": (rows_k - rows_p).abs().max().item(),
                "chain_energy": abs(ee_k.item() - ee_p.item())}
        rows_equal = torch.equal(rows_k, rows_p)
        gaps = {"chain_blocks": abs(eb_k.item() - eb_p.item()) / abs(eb_p.item()),
                "chain_energy": abs(ee_k.item() - ee_p.item()) / abs(ee_p.item())}
        del rows_k, rows_p
        sleep = int(2e7)
        bounds = kernel_bounds(n, m, k_obs, bw, op_rate)
        plain = {"chain_blocks": lambda: cuda_chain.chain_blocks_plain(
                     fast, prob.obs, prob.tau2),
                 "chain_energy": lambda: cuda_chain.fused_energy_plain(
                     fast, prob.obs, prob.tau2)}
        for which in extra:
            extra[which]["ladybug"] = {
                "n_cameras": n, "K": k_obs,
                "ms": time_ms(lambda: cuda_chain.launch(which, ops, prob.tau2),
                              20, sleep, flush),
                "plain_ms": time_ms(plain[which], 10, int(2e8), flush),
                "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
                "max_abs_err": errs[which], "energy_rel_err": gaps[which],
                **cuda_chain.launch_shape(which, n, k_obs)}
        emit({"phase": "cli_ladybug_df32", "generate_s": gen_s, "write_s": write_s,
              "file_bytes": path.stat().st_size, **line, "launches": launches,
              "rows_equal": rows_equal,
              "kernels": {w: extra[w]["ladybug"] for w in extra},
              "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase})
        check(rows_equal, f"cli_ladybug_df32: rows differ by {errs['chain_blocks']}")
        for which, gap in gaps.items():
            check(gap <= ENERGY_RTOL, f"cli_ladybug_df32: {which} energy rel err {gap}")
        for which in extra:
            check(not extra[which]["ladybug"]["staged_cameras"],
                  f"cli_ladybug_df32: {which} staged the cameras")
    return extra


#: The sharded phases' tolerances against the single-device run of the
#: same configuration. NCCL at world size 1 runs the same arithmetic: equal
#: LM paths, energies within NCCL_RTOL. gloo ranks sum their partial camera
#: systems in another order than one device does. On the float64 drive
#: that moves a run's energy at the rounding level: equal LM paths, and
#: energies within SHARDED_F64_RTOL (p16 at 2 ranks on the CPU, 5
#: iterations: <= 1.7e-7, qrchol). On the df32 drive float32 rounding,
#: amplified by the reduced system's conditioning, parts the LM paths
#: within a few iterations (p16 at 2 ranks on the CPU: 6.1% apart after 5),
#: so a df32 run is held to descent and rank agreement, and one prepare
#: and trial at the loaded state to the single device's: the energy to
#: SHARDED_PREPARE_RTOL (a sum of per-rank DF sums), lambda0 to
#: SHARDED_LAMBDA_RTOL (float32 U summed in another order), the trial
#: energy at AGREE_LAMBDA_FACTOR x lambda0 to SHARDED_DF32_RTOL (the JAX
#: package's sharded df32 test; p16 at 2 and 4 ranks on the CPU: <= 2.4e-6).
#: At lambda0 itself the float32 reduced system is singular to rounding
#: (the Cholesky breaks down) and the trial is noise (3% apart on p16).
NCCL_RTOL = 1e-12
SHARDED_F64_RTOL = 1e-6
SHARDED_PREPARE_RTOL = 1e-9
SHARDED_LAMBDA_RTOL = 1e-5
SHARDED_DF32_RTOL = 2e-3
DF32 = {"matmul_dtype": "float32", "geometry": "df32"}
MODES = ("cholesky", "qrchol", "moreqr", "qrkit", "spqr")


def portable(prob):
    """What a rank needs of a problem to shard it, on the CPU: the state
    and the observations (each shard builds its own tables)."""
    return dataclasses.replace(prob, pairs=None, pt_banded=None,
                               cam_banded=None).to("cpu")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def sharded_rank(rank, device, problems, runs, checkpoint_path=None) -> list:
    """One rank of a sharded group on the card: each run of ``runs`` (name,
    problem, mode, iters, config; optionally warmup, bytes, checkpoint)
    through ``sharded.minimize_sharded``, timed after an optional
    one-iteration warm-up, with this rank's chain-kernel launches and peak
    device memory and a digest of its final cameras and points (all ranks
    must agree). With ``bytes``, one prepare and one trial at the loaded
    state and AGREE_LAMBDA_FACTOR x lambda0: their energies and all-reduce
    traffic."""
    import torch.distributed as dist

    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain
    from bundleadjustment_benchmarks_tpu_torch.parallel import sharded
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm

    n = dist.get_world_size()
    shards, out = {}, []
    for run in runs:
        t0 = time.perf_counter()
        if run["problem"] not in shards:
            shards[run["problem"]] = sharded.shard_problem(
                problems[run["problem"]], n, rank, device=device)
        sp = shards[run["problem"]]
        shard_s = time.perf_counter() - t0
        cfg = lm.LMConfig(max_iter=run["iters"], **run.get("config", {}))
        if run.get("warmup"):
            sharded.minimize_sharded(sp, run["mode"], dataclasses.replace(cfg, max_iter=1))
        observe = (dict(checkpoint_path=checkpoint_path, checkpoint_every=2)
                   if run.get("checkpoint") else {})
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        cuda_chain.reset_launches()
        t0 = time.perf_counter()
        res = sharded.minimize_sharded(sp, run["mode"], cfg, **observe)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        line = {"run": run["name"], "rank": rank, "shards": n,
                "backend": dist.get_backend(), "problem": run["problem"],
                "mode": run["mode"], "drive": "df32" if cfg.geometry else "f64",
                "observations": sp.problem.n_observations,
                "points": sp.problem.n_points, "shard_s": shard_s,
                "iterations": res.iterations, "fun_evals": res.fun_evals,
                "status": res.status.name, "final_energy": res.energy,
                "lam": res.lam, "wall_s": wall,
                "lm_iter_per_s": res.iterations / wall,
                "launches": dict(cuda_chain.LAUNCHES),
                "max_memory_allocated": torch.cuda.max_memory_allocated(device),
                "digest": digest(res.state.T) + digest(res.state.points)}
        if run.get("bytes"):
            reduce = sharded.AllReduce(sp)
            prepare, trial, to_loop, _ = lm.step_functions(
                sp.problem, run["mode"], cfg, device, reduce)
            x = to_loop(sp.problem.state)
            ctx, energy, lam0 = prepare(x)
            done = reduce.bytes, reduce.calls
            _, e_test, _ = trial(ctx, x, AGREE_LAMBDA_FACTOR * float(lam0))
            line["allreduce_per_prepare"] = {"bytes": done[0], "calls": done[1]}
            line["allreduce_per_trial"] = {"bytes": reduce.bytes - done[0],
                                           "calls": reduce.calls - done[1]}
            line["first_trial"] = first_trial_line(energy, lam0, e_test)
        out.append(line)
    return out


def first_trial_line(energy, lam0, e_test) -> dict:
    return {"energy": float(energy), "lambda0": float(lam0),
            "trial_energy": float(e_test)}


def single_runs(lm, problems, runs) -> dict:
    """The single-device lm.minimize of each sharded run's configuration,
    {name: (iterations, fun_evals, status name, energy, first trial)}: the
    first trial (with ``bytes``) is one prepare and one trial at the loaded
    state and AGREE_LAMBDA_FACTOR x lambda0."""
    out = {}
    for run in runs:
        prob = problems[run["problem"]]
        cfg = lm.LMConfig(max_iter=run["iters"], **run.get("config", {}))
        res = lm.minimize(prob, run["mode"], cfg)
        first = None
        if run.get("bytes"):
            prepare, trial, to_loop, _ = lm.step_functions(
                prob, run["mode"], cfg, prob.state.T.device)
            x = to_loop(prob.state)
            ctx, energy, lam0 = prepare(x)
            first = first_trial_line(
                energy, lam0, trial(ctx, x, AGREE_LAMBDA_FACTOR * float(lam0))[1])
        out[run["name"]] = (res.iterations, res.fun_evals, res.status.name,
                            res.energy, first)
    return out


def first_trial_gaps(sharded_first, single_first) -> dict:
    """Relative gaps of the first prepare and trial, sharded to single."""
    return {k: abs(sharded_first[k] - single_first[k]) / abs(single_first[k])
            for k in single_first}


def summarize(lines: list, single: dict, e0: dict) -> dict:
    """Per run of a sharded group: rank 0's numbers, every rank's launches
    and peak memory, whether the ranks agree, and the gaps to the
    single-device run."""
    runs = {}
    for rank_lines in lines:
        for line in rank_lines:
            runs.setdefault(line["run"], []).append(line)
    out = {}
    keys = ("iterations", "fun_evals", "status", "final_energy", "lam", "digest")
    for name, per_rank in runs.items():
        lead = per_rank[0]
        it, ev, status, energy, first = single.get(name, (None,) * 5)
        run = {
            **{k: lead[k] for k in ("shards", "backend", "problem", "mode", "drive",
                                    "iterations", "fun_evals", "status",
                                    "final_energy", "wall_s", "lm_iter_per_s")},
            **{k: lead[k] for k in ("allreduce_per_prepare", "allreduce_per_trial")
               if k in lead},
            "initial_energy": e0.get(lead["problem"]),
            "ranks_agree": all([r[k] for k in keys] == [lead[k] for k in keys]
                               for r in per_rank),
            "launches_per_rank": [r["launches"] for r in per_rank],
            "observations_per_rank": [r["observations"] for r in per_rank],
            "max_memory_allocated_per_rank": [r["max_memory_allocated"]
                                              for r in per_rank],
            "shard_s_per_rank": [r["shard_s"] for r in per_rank],
            "single": {"iterations": it, "fun_evals": ev, "status": status,
                       "final_energy": energy},
            "rel_gap": None if energy is None
            else abs(lead["final_energy"] - energy) / energy,
        }
        if first is not None:
            run["first_trial"] = lead["first_trial"]
            run["first_trial_rel_gap"] = first_trial_gaps(lead["first_trial"], first)
        out[name] = run
    return out


def sharded_phases(pm, lm, sharded, multihost, cli, checkpoint, cuda_chain,
                   problems, ladybug, smi) -> dict:
    """The sharded path on the card: NCCL at world size 1 on p257
    (``sharded_nccl_p257``), 2 and 4 gloo ranks sharing the card on p257 and
    the Ladybug stand-in (``sharded_gloo_p257``, ``sharded_ladybug_df32``),
    every mode on the float64 drive at 2 ranks (``sharded_f64_p16``), the
    command line's ``--shards`` and a checkpoint written at 2 ranks resumed
    on one device (``cli_shards``), and the dry run at 1 and 2 ranks
    (``dryrun_multichip``). Returns per kernel the launches per rank."""
    extra = {"chain_blocks": {}, "chain_energy": {}}
    p257 = problems["p257"]
    e0 = {"p257": cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs,
                                          p257.tau2).item(),
          "p16": float(lm._prepare(problems["p16"].state, problems["p16"],
                                   "cholesky")[1])}

    # -- NCCL, world size 1: p257 df32 cholesky, 10 iterations ---------------
    t_phase = time.perf_counter()
    nccl = dict(name="cholesky_10", problem="p257", mode="cholesky", iters=10,
                config=DF32, warmup=True, bytes=True)
    single = single_runs(lm, problems, [nccl])
    lines = multihost.run_ranks(sharded_rank, ["cuda:0"],
                                args=({"p257": p257}, [nccl]))
    (run,) = summarize(lines, single, e0).values()
    emit({"phase": "sharded_nccl_p257", **run, "tolerance": NCCL_RTOL,
          "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase})
    check(run["backend"] == "nccl", f"sharded_nccl_p257: backend {run['backend']}")
    check((run["iterations"], run["fun_evals"], run["status"])
          == tuple(single["cholesky_10"][:3]),
          f"sharded_nccl_p257: LM path {run} differs from one device's")
    check(run["rel_gap"] <= NCCL_RTOL, f"sharded_nccl_p257: energy gap {run['rel_gap']}")
    for which in extra:
        count = run["launches_per_rank"][0][which]
        check(count > 0, f"sharded_nccl_p257: {which} not launched")
        extra[which]["launches_sharded_nccl_p257"] = count

    # -- gloo: 2 and 4 ranks on the one card ------------------------------------
    t_phase = time.perf_counter()
    n, m, _ = LADYBUG
    ds, _ = ladybug
    t0 = time.perf_counter()
    lady = pm.from_bal_dataset(ds, device="cuda")
    load_s = time.perf_counter() - t0
    e0["ladybug"] = cuda_chain.fused_energy(pm.to_fast(lady.state), lady.obs,
                                            lady.tau2).item()
    local = {"p257": portable(p257), "p16": portable(problems["p16"]),
             "ladybug": portable(lady)}
    five = dict(name="cholesky_5", problem="p257", mode="cholesky", iters=5,
                config=DF32, warmup=True, bytes=True)
    modes = [dict(name=f"{mode}_3", problem="p257", mode=mode, iters=3,
                  config=DF32, warmup=True) for mode in MODES]
    f64 = [dict(name=f"{mode}_f64", problem="p16", mode=mode, iters=5)
           for mode in MODES]
    ck_run = dict(name="checkpoint", problem="p257", mode="cholesky", iters=4,
                  config=DF32, checkpoint=True)
    lady_run = dict(name="ladybug", problem="ladybug", mode="cholesky", iters=2,
                    config=DF32, bytes=True)
    single = single_runs(lm, {**problems, "ladybug": lady},
                         [five] + modes + f64 + [lady_run])
    del lady
    torch.cuda.empty_cache()
    groups = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        ck = str(Path(tmp_name) / "d2.ckpt.npz")
        for d, runs in ((2, [five] + modes + f64 + [ck_run, lady_run]), (4, [five])):
            t0 = time.perf_counter()
            lines = multihost.run_ranks(sharded_rank, ["cuda:0"] * d,
                                        args=(local, runs, ck), timeout=600)
            groups[d] = summarize(lines, single, e0)
            groups[d]["group_s"] = time.perf_counter() - t0
        state, meta = checkpoint.load_checkpoint(ck, device="cuda")
    resumed = lm.minimize(p257, "cholesky", lm.LMConfig(max_iter=6, **DF32),
                          state=state, resume=meta)
    for d, group in groups.items():
        for name, run in group.items():
            if name == "group_s":
                continue
            phase = {"p257": "sharded_gloo_p257", "p16": "sharded_f64_p16",
                     "ladybug": "sharded_ladybug_df32"}[run["problem"]]
            tol = SHARDED_F64_RTOL if run["drive"] == "f64" else SHARDED_DF32_RTOL
            tolerances = ({"tolerance": tol} if run["drive"] == "f64" else {
                "tolerance_first_trial": {"energy": SHARDED_PREPARE_RTOL,
                                          "lambda0": SHARDED_LAMBDA_RTOL,
                                          "trial_energy": tol}})
            emit({"phase": phase, "run": name, **run, **tolerances,
                  "group_s": group["group_s"], "nvidia_smi": smi})
            where = f"{phase} {name} D={d}"
            check(run["backend"] == "gloo", f"{where}: backend {run['backend']}")
            check(run["ranks_agree"], f"{where}: the ranks disagree")
            check(np.isfinite(run["final_energy"])
                  and run["final_energy"] < run["initial_energy"],
                  f"{where}: energy {run['final_energy']} not below "
                  f"{run['initial_energy']}")
            if run["drive"] == "df32":
                for launches in run["launches_per_rank"]:
                    check(all(c > 0 for c in launches.values()),
                          f"{where}: a rank did not launch both kernels")
            if run["drive"] == "f64":
                check((run["iterations"], run["fun_evals"], run["status"])
                      == tuple(single[name][:3]) and run["rel_gap"] <= tol,
                      f"{where}: LM path or energy ({run['rel_gap']}) differs "
                      "from one device's")
            if "first_trial_rel_gap" in run:
                gaps = run["first_trial_rel_gap"]
                check(gaps["energy"] <= SHARDED_PREPARE_RTOL
                      and gaps["lambda0"] <= SHARDED_LAMBDA_RTOL
                      and gaps["trial_energy"] <= tol,
                      f"{where}: first prepare and trial {gaps} off one device's")
    for which in extra:
        for d in groups:
            extra[which][f"launches_sharded_gloo_p257_d{d}"] = [
                r[which] for r in groups[d]["cholesky_5"]["launches_per_rank"]]
        extra[which]["launches_sharded_ladybug_d2"] = [
            r[which] for r in groups[2]["ladybug"]["launches_per_rank"]]
    emit({"phase": "sharded_gloo_done", "ladybug_load_s": load_s,
          "checkpoint_d2_resumed_on_one_device": {
              "checkpoint_iteration": meta["iteration"],
              "iterations": resumed.iterations, "fun_evals": resumed.fun_evals,
              "status": resumed.status.name, "final_energy": resumed.energy},
          "phase_s": time.perf_counter() - t_phase})
    check(meta["iteration"] == 4 and resumed.iterations == 7
          and np.isfinite(resumed.energy) and resumed.energy < e0["p257"],
          f"sharded_gloo: the D=2 checkpoint did not resume ({meta}, {resumed})")

    # -- the command line's --shards -------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        log = ["--log-file", tmp / "run.log"]
        metrics = tmp / "shards1.jsonl"
        cuda_chain.reset_launches()
        rc, out = run_cli(cli, [P257, "--precision", "mixed", "--shards", 1,
                                "--max-iters", 5, "--quiet", "--metrics",
                                metrics] + log)
        launches = dict(cuda_chain.LAUNCHES)
        check(rc == cli.RETURN_SUCCESS, f"cli_shards --shards 1: rc {rc}")
        line = cli_summary(out, metrics)
        gpus = torch.cuda.device_count()
        rc2, _ = run_cli(cli, [P257, "--shards", 2, "--max-iters", 1, "--quiet"] + log)
    want = cli.RETURN_WRONG_INPUT_PARAMS if gpus < 2 else cli.RETURN_SUCCESS
    emit({"phase": "cli_shards", **line, "launches": launches,
          "shards_2_rc": rc2, "gpus": gpus, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(line["objective_post"] < line["objective_pre"],
          "cli_shards: the true objective did not descend")
    check(all(c > 0 for c in launches.values()), "cli_shards: a kernel not launched")
    check(rc2 == want, f"cli_shards: --shards 2 with {gpus} GPU(s) returned {rc2}")
    for which in extra:
        extra[which]["launches_cli_shards_1"] = launches[which]

    # -- the dry run --------------------------------------------------------------
    t_phase = time.perf_counter()
    runs = {"n1": sharded.dryrun_multichip(1),
            "n2": sharded.dryrun_multichip(2, devices=["cuda:0", "cuda:0"])}
    emit({"phase": "dryrun_multichip", **runs, "phase_s": time.perf_counter() - t_phase})
    check(runs["n1"]["backend"] == "nccl" and runs["n2"]["backend"] == "gloo",
          "dryrun_multichip: backends")
    for name, run in runs.items():
        check(all(c > 0 for c in run["launches"].values()),
              f"dryrun_multichip {name}: the df32 configuration launched no kernel")
    return extra


#: The jit drive against the host drive: energies within this relative gap
#: where both take the same LM path; where float32 rounding parts the paths
#: (atomic sums run in another order from run to run), one captured prepare
#: and trial at AGREE_LAMBDA_FACTOR x lambda0 against the eager one within
#: JIT_TRIAL_RTOL (the sharded path's gate), and descent.
JIT_RTOL = 1e-9
JIT_TRIAL_RTOL = 2e-3


def timed_minimize(lm, cuda_chain, prob, mode, cfg) -> dict:
    """One lm.minimize, synchronized: result, wall, peak allocated bytes,
    reserved bytes after, chain launches and (jit) the drive's counters."""
    torch.cuda.synchronize()
    cuda_chain.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = lm.minimize(prob, mode, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"res": res, "wall_s": wall, "it_per_s": res.iterations / wall,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved(),
            "launches": dict(cuda_chain.LAUNCHES),
            "jit": dict(lm.LAST_JIT_RUN) if cfg.drive == "jit" else None}


def loop_under_test(lm, prob, mode, cfg):
    """The cached jit-drive loop that ``lm.minimize(prob, mode, cfg)`` with
    ``drive="jit"`` replayed, its step functions and start state."""
    dev = prob.state.T.device
    cfg = dataclasses.replace(cfg, drive="jit")
    prepare, trial, to_loop, _ = lm.step_functions(prob, mode, cfg, dev)
    x0 = to_loop(prob.state)
    loop, capture_s = lm._device_loop(prob, mode, cfg, x0, dev, prepare, trial)
    check(capture_s == 0.0, f"{mode}: the jit run's graph is not cached")
    return loop, prepare, trial, x0


def first_trial(lm, prob, mode, cfg) -> dict:
    """One prepare and one trial at AGREE_LAMBDA_FACTOR x lambda0 from the
    loaded state: eager at a float lambda (the host drive) and as one slot
    of the jit run's own captured loop (``DeviceLoop.first_trial``)."""
    loop, prepare, trial, x0 = loop_under_test(lm, prob, mode, cfg)
    ctx, energy, lam0 = prepare(x0)
    lam = AGREE_LAMBDA_FACTOR * float(lam0)
    host = trial(ctx, x0, lam)[1].item()
    jit = loop.first_trial(x0, lam)
    return {"energy": energy.item(), "lambda0": lam0.item(), "host_trial": host,
            "jit_trial": jit, "rel_gap": abs(jit - host) / abs(host)}


def parting_iteration(lm, prob, mode, cfg) -> Optional[int]:
    """The first iteration whose accepted energy differs between the host
    and the jit drive (traced runs), or None."""
    traces = {}
    for drive in ("host", "jit"):
        traces[drive] = []
        lm.minimize(prob, mode, dataclasses.replace(cfg, drive=drive),
                    trace=traces[drive])
    for a, b in zip(traces["host"], traces["jit"]):
        if a["iter"] != b["iter"] or a["energy"] != b["energy"]:
            return a["iter"]
    return None


def hold_jit(lm, prob, mode, cfg, host, jit, e0, where) -> dict:
    """The gate of a jit run against a host run: always the same iterations,
    function evaluations and status; energies within JIT_RTOL, or, only
    where float32 rounding parts the two paths (the iteration where they
    part is printed), the jit loop's own first trial at AGREE_LAMBDA_FACTOR
    x lambda0 against the eager one within JIT_TRIAL_RTOL, and descent."""
    h, j = host["res"], jit["res"]
    gap = abs(j.energy - h.energy) / abs(h.energy)
    check((h.iterations, h.fun_evals, h.status) == (j.iterations, j.fun_evals,
                                                     j.status),
          f"{where}: host {h.iterations} iterations, {h.fun_evals} evaluations, "
          f"{h.status.name}; jit {j.iterations}, {j.fun_evals}, {j.status.name}")
    out = {"same_path": gap <= JIT_RTOL, "energy_rel_gap": gap}
    if out["same_path"]:
        out["gate"] = "same LM path, energies within 1e-9"
        return out
    parted = parting_iteration(lm, prob, mode, cfg)
    print(f"{where}: the drives part at iteration {parted}", flush=True)
    check(parted is not None,
          f"{where}: energies {gap} apart, but the traced runs do not part")
    first = first_trial(lm, prob, mode, cfg)
    out.update(parted_at_iteration=parted, first_trial=first,
               gate="same counts; first trial at 1e4 x lambda0 within 2e-3, "
               "and descent")
    check(first["rel_gap"] <= JIT_TRIAL_RTOL,
          f"{where}: the jit loop's first trial {first}")
    check(np.isfinite(j.energy) and j.energy < e0,
          f"{where}: jit energy {j.energy} not below {e0}")
    return out


def chunks_and_trials(lm, res, chunk: int) -> tuple:
    """(host reads, trials) a jit run of result ``res`` should show: one
    read per chunk of the iterations it started, and a trial for every
    evaluation that was not an iteration's prepare."""
    started = res.iterations - (res.status in (
        lm.LMStatus.MaxItersReached, lm.LMStatus.TooManyFunctionEvaluation))
    return -(-started // chunk), res.fun_evals - started


def summary(run: dict) -> dict:
    res = run["res"]
    out = {"iterations": res.iterations, "fun_evals": res.fun_evals,
           "status": res.status.name, "energy": res.energy,
           **{k: run[k] for k in ("wall_s", "it_per_s", "peak_bytes",
                                  "reserved_bytes", "launches")}}
    if run["jit"]:
        out.update(run["jit"])
    return out


def jit_phases(pm, lm, cuda_chain, cuda_graph, problems, ladybug, smi) -> dict:
    """The device-resident drive (``drive="jit"``): ``jit_kernels_replayed``
    (both chain kernels replayed from a graph equal the eager launch and the
    plain version bit for bit, and count once per replay that runs them),
    ``jit_p257_df32`` (cholesky, 20 iterations, jit and host alternated
    three times each), ``jit_modes`` (all five modes at p257 df32 and p16
    float64), ``jit_ladybug_df32`` (the Ladybug stand-in, both drives'
    peaks) and ``jit_no_sync`` (the chunk loop under
    ``torch.cuda.set_sync_debug_mode("error")`` between its reads).
    Returns per kernel its launches in the jit p257 run."""
    dev = torch.device("cuda", 0)
    extra = {"chain_blocks": {}, "chain_energy": {}}

    # -- jit_kernels_replayed ------------------------------------------------
    t_phase = time.perf_counter()
    cases = []
    for name in ("p16", "p257"):
        prob = problems[name]
        ops = cuda_chain.chain_operands(pm.to_fast(prob.state), prob.obs)
        tau2 = prob.tau2
        rows_p, eb_p = cuda_chain.chain_blocks_plain(pm.to_fast(prob.state),
                                                     prob.obs, tau2)
        ee_p = cuda_chain.fused_energy_plain(pm.to_fast(prob.state), prob.obs, tau2)
        rows_e, eb_e = cuda_chain.launch("chain_blocks", ops, tau2)
        _, ee_e = cuda_chain.launch("chain_energy", ops, tau2)
        graph = cuda_graph.DeviceGraph(dev)
        with torch.cuda.stream(graph.stream):
            cuda_chain.prepare_capture(dev)
        pred = torch.ones((), dtype=torch.bool, device=dev)
        out = {}

        def body():
            out["rows"], out["eb"] = cuda_chain.launch("chain_blocks", ops, tau2)
            out["ee"] = cuda_chain.launch("chain_energy", ops, tau2)[1]

        graph.capture(lambda: cuda_graph.device_if(pred, body))
        cuda_chain.reset_launches()
        graph.replay()
        graph.replay()
        pred.fill_(False)
        graph.replay()
        torch.cuda.synchronize()
        cuda_chain.collect_graph_launches()
        case = {"problem": name, "K": prob.n_observations,
                "rows_equal_eager": torch.equal(out["rows"], rows_e),
                "rows_equal_plain": torch.equal(out["rows"], rows_p),
                "blocks_energy_equal_eager": out["eb"].item() == eb_e.item(),
                "energy_equal_eager": out["ee"].item() == ee_e.item(),
                "blocks_energy_rel_err_plain":
                    abs(out["eb"].item() - eb_p.item()) / abs(eb_p.item()),
                "energy_rel_err_plain":
                    abs(out["ee"].item() - ee_p.item()) / abs(ee_p.item()),
                "launches_3_replays_2_taken": dict(cuda_chain.LAUNCHES)}
        graph.close()
        cases.append(case)
        check(case["rows_equal_eager"] and case["rows_equal_plain"],
              f"jit_kernels_replayed {name}: replayed rows differ")
        check(case["blocks_energy_equal_eager"] and case["energy_equal_eager"],
              f"jit_kernels_replayed {name}: replayed energies differ from eager")
        check(case["blocks_energy_rel_err_plain"] <= ENERGY_RTOL
              and case["energy_rel_err_plain"] <= ENERGY_RTOL,
              f"jit_kernels_replayed {name}: energies against plain {case}")
        check(case["launches_3_replays_2_taken"] == {"chain_blocks": 2,
                                                     "chain_energy": 2},
              f"jit_kernels_replayed {name}: counted {case['launches_3_replays_2_taken']}")
    emit({"phase": "jit_kernels_replayed", "cases": cases, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})

    # -- jit_p257_df32 ---------------------------------------------------------
    t_phase = time.perf_counter()
    p257 = problems["p257"]
    kw = dict(matmul_dtype="float32", geometry="df32")
    e0 = cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs, p257.tau2).item()
    reserved0 = torch.cuda.memory_reserved()
    warm = {d: timed_minimize(lm, cuda_chain, p257, "cholesky",
                              lm.LMConfig(drive=d, max_iter=2, **kw))
            for d in ("host", "jit")}
    capture = dict(warm["jit"]["jit"],
                   reserved_by_capture=torch.cuda.memory_reserved() - reserved0)
    runs = {"host": [], "jit": []}
    for drive in ("host", "jit", "jit", "host", "host", "jit"):
        runs[drive].append(timed_minimize(
            lm, cuda_chain, p257, "cholesky",
            lm.LMConfig(drive=drive, max_iter=20, **kw)))
    gate = hold_jit(lm, p257, "cholesky", lm.LMConfig(max_iter=20, **kw),
                    runs["host"][0], runs["jit"][0], e0, "jit_p257_df32")
    jit_launches = runs["jit"][0]["launches"]
    emit({"phase": "jit_p257_df32", "mode": "cholesky", "initial_energy": e0,
          "capture": capture, **gate,
          "host_it_per_s": [r["it_per_s"] for r in runs["host"]],
          "jit_it_per_s": [r["it_per_s"] for r in runs["jit"]],
          "host": [summary(r) for r in runs["host"]],
          "jit": [summary(r) for r in runs["jit"]],
          "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase})
    for which, count in jit_launches.items():
        check(count > 0, f"jit_p257_df32: {which} not launched in the graph")
        extra[which]["launches_jit_p257_df32"] = count
    for r in runs["jit"]:
        reads, trials = chunks_and_trials(lm, r["res"], lm.LMConfig().chunk_size)
        check((r["jit"]["reads"], r["jit"]["replays"], r["jit"]["slots"])
              == (reads, reads, trials),
              f"jit_p257_df32: {r['jit']} for {r['res'].iterations} iterations, "
              f"{r['res'].fun_evals} evaluations")

    # -- jit_no_sync -------------------------------------------------------------
    t_phase = time.perf_counter()
    cfg = lm.LMConfig(drive="jit", max_iter=20, **kw)
    prepare, trial, to_loop, _ = lm.step_functions(p257, "cholesky", cfg, dev)
    x0 = to_loop(p257.state)
    loop, capture_s = lm._device_loop(p257, "cholesky", cfg, x0, dev, prepare, trial)
    loop.reads = 0
    _, status, it, fun_evals, energy, _ = loop.run(x0, sync_debug=True,
                                                   config=cfg)
    torch.cuda.synchronize()
    emit({"phase": "jit_no_sync", "iterations": it, "fun_evals": fun_evals,
          "status": status.name, "energy": energy, "reads": loop.reads,
          "captured_here": capture_s > 0, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(capture_s == 0.0, "jit_no_sync: the p257 graph was not cached")
    check((it, fun_evals) == (runs["jit"][0]["res"].iterations,
                              runs["jit"][0]["res"].fun_evals),
          f"jit_no_sync: {it} iterations, {fun_evals} evaluations")
    check(np.isfinite(energy) and energy < e0, f"jit_no_sync: energy {energy}")
    lm.clear_graphs()

    # -- jit_modes -----------------------------------------------------------------
    t_phase = time.perf_counter()
    for name, iters, kw_mode in (("p257", 5, kw), ("p16", 10, {})):
        prob = problems[name]
        for mode in MODES:
            cfg = lm.LMConfig(max_iter=iters, **kw_mode)
            if kw_mode:
                e0_m = cuda_chain.fused_energy(pm.to_fast(prob.state), prob.obs,
                                               prob.tau2).item()
            else:
                e0_m = float(lm._prepare(prob.state, prob, mode)[1])
            lm.minimize(prob, mode, dataclasses.replace(cfg, drive="jit",
                                                        max_iter=1))
            capture = dict(lm.LAST_JIT_RUN)
            host = timed_minimize(lm, cuda_chain, prob, mode, cfg)
            jit = timed_minimize(lm, cuda_chain, prob, mode,
                                 dataclasses.replace(cfg, drive="jit"))
            gate = hold_jit(lm, prob, mode, cfg, host, jit, e0_m,
                            f"jit_modes {name} {mode}")
            reads, trials = chunks_and_trials(lm, jit["res"], cfg.chunk_size)
            check((jit["jit"]["reads"], jit["jit"]["slots"]) == (reads, trials),
                  f"jit_modes {name} {mode}: {jit['jit']}")
            emit({"phase": "jit_modes", "problem": name, "mode": mode,
                  "drive": "df32" if kw_mode else "f64", "capture": capture,
                  **gate, "host": summary(host), "jit": summary(jit),
                  "nvidia_smi": smi})
            if kw_mode:
                for which, count in jit["launches"].items():
                    check(count == host["launches"][which] or not gate["same_path"],
                          f"jit_modes {name} {mode}: {which} launched "
                          f"{count} times in the graph, {host['launches'][which]} "
                          "by the host drive")
            lm.clear_graphs()
    emit({"phase": "jit_modes_done", "phase_s": time.perf_counter() - t_phase})

    # -- jit_ladybug_df32 ------------------------------------------------------------
    t_phase = time.perf_counter()
    ds, _ = ladybug
    lady = pm.from_bal_dataset(ds, device=dev)
    e0 = cuda_chain.fused_energy(pm.to_fast(lady.state), lady.obs, lady.tau2).item()
    reserved0 = torch.cuda.memory_reserved()
    lm.minimize(lady, "cholesky", lm.LMConfig(drive="jit", max_iter=1, **kw))
    capture = dict(lm.LAST_JIT_RUN,
                   reserved_by_capture=torch.cuda.memory_reserved() - reserved0)
    cfg = lm.LMConfig(max_iter=3, **kw)
    host = timed_minimize(lm, cuda_chain, lady, "cholesky", cfg)
    jit = timed_minimize(lm, cuda_chain, lady, "cholesky",
                         dataclasses.replace(cfg, drive="jit"))
    gate = hold_jit(lm, lady, "cholesky", cfg, host, jit, e0, "jit_ladybug_df32")
    emit({"phase": "jit_ladybug_df32", "N": lady.n_cameras, "M": lady.n_points,
          "K": lady.n_observations, "initial_energy": e0, "capture": capture,
          **gate, "host": summary(host), "jit": summary(jit), "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    lm.clear_graphs()
    del lady
    torch.cuda.empty_cache()
    return extra



P16_ORACLE = HERE / "benchmarks" / "results" / "cpu_p16_flatline.json"


def flatline_phase(campaign, cuda_chain, smi) -> None:
    """``flatline_p16_f64``: every mode from the loaded p16 state to the
    flatline stop on the float64 drive (``flatline_campaign.run_row``: a
    2-iteration warm-up, then the timed run), each held to the JAX
    campaign's f64 budget (``flatline_campaign.BUDGETS``) against the scipy
    oracle's p16 flatline. The float64 drive launches no chain kernel."""
    t_phase = time.perf_counter()
    budget = campaign.BUDGETS["f64"]
    oracle = json.loads(P16_ORACLE.read_text())["post"]
    problem, name = campaign.load_problem("p16", "cuda")
    for mode in MODES:
        row, state = campaign.run_row(problem, name, mode, "f64", device="cuda")
        verdict = campaign.budget_gaps(row["post"], oracle, budget)
        emit({"phase": "flatline_p16_f64",
              **{k: row[k] for k in ("mode", "status", "iterations", "fun_evals",
                                     "energy", "wall_s", "it_per_s", "peak_bytes",
                                     "launches", "post")},
              "oracle": oracle, "budget": budget, **verdict, "nvidia_smi": smi})
        check(row["status"] in ("Success (Energy Flatlined)",
                                "Success (Exceeded Maximum Lambda)"),
              f"flatline_p16_f64 {mode}: stopped with {row['status']!r}")
        check(bool(torch.isfinite(state.points).all()),
              f"flatline_p16_f64 {mode}: points not finite")
        check(verdict["within"],
              f"flatline_p16_f64 {mode}: {verdict} outside {budget}")
        check(all(c == 0 for c in row["launches"].values()),
              f"flatline_p16_f64 {mode}: the float64 drive launched {row['launches']}")
    emit({"phase": "flatline_p16_f64_done", "phase_s": time.perf_counter() - t_phase})


def ellipse_phase(lm, smi) -> None:
    """``ellipse``: ``examples/ellipse_fitting_torch.py`` on the card, held
    to tests/test_examples.py's assertions, and its gap to the same fit on
    the CPU."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(HERE / "examples"))
    import ellipse_fitting_torch as example

    samples = example.sample_ellipse(center=(1.0, -2.0), axes=(3.0, 1.5), phi=0.6)
    t0 = time.perf_counter()
    res = example.fit_ellipse(samples, device="cuda")
    wall = time.perf_counter() - t0
    cpu = example.fit_ellipse(samples, device="cpu")
    cx, cy, a, b, phi = res.state.tolist()
    emit({"phase": "ellipse", "status": res.status.name,
          "iterations": res.iterations, "fun_evals": res.fun_evals,
          "energy": res.energy, "params": [cx, cy, a, b, phi], "wall_s": wall,
          "cpu": {"status": cpu.status.name, "iterations": cpu.iterations,
                  "params_max_abs_gap": (res.state.cpu() - cpu.state).abs().max().item()},
          "device": str(res.state.device), "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(res.state.is_cuda, "ellipse: the fit did not run on the card")
    check(res.status in (lm.LMStatus.Success, lm.LMStatus.MaxItersReached),
          f"ellipse: status {res.status.name}")
    check(abs(cx - 1.0) <= 0.02 and abs(cy + 2.0) <= 0.02,
          f"ellipse: centre ({cx}, {cy})")
    check(all(abs(v - w) <= 0.05 for v, w in zip(sorted([a, b]), [1.5, 3.0])),
          f"ellipse: axes ({a}, {b})")
    check(res.energy < 0.05, f"ellipse: energy {res.energy}")


#: blocked_chol: the reduced systems' sizes at p257 (9 x 257) and at the
#: Ladybug stand-in (9 x 1,723).
BLOCKED_SIZES = (2313, 15507)


def blocked_chol_phase(linalg, flush, smi) -> None:
    """``blocked_chol``: ``ops/linalg.blocked_cholesky`` against float32
    ``torch.linalg.cholesky_ex``, and the two products through
    ``blocked_tril_inv`` against ``torch.cholesky_solve``, on a
    Jacobi-scaled SPD matrix (G G^T / 2n for a normal (n, 2n) G, scaled to
    a unit diagonal) at each of BLOCKED_SIZES: median of 20 by CUDA events,
    cold L2, and each float32 result's relative error against the float64
    factor and solve."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sleep = int(2e7)
    for n in BLOCKED_SIZES:
        G = torch.randn((n, 2 * n), dtype=torch.float64, device="cuda", generator=gen)
        S = G @ G.T / (2 * n)
        del G
        d = S.diagonal().rsqrt()
        S = S * d[:, None] * d[None, :]
        b = torch.randn(n, dtype=torch.float64, device="cuda", generator=gen)
        L64 = torch.linalg.cholesky(S)
        x64 = torch.cholesky_solve(b[:, None], L64)[:, 0]
        S32, b32 = S.float(), b.float()
        del S
        Lc, info_c = torch.linalg.cholesky_ex(S32)
        Lb, info_b = linalg.blocked_cholesky(S32)
        X = linalg.blocked_tril_inv(Lb)
        xc = torch.cholesky_solve(b32[:, None], Lc)[:, 0]
        xb = X.T @ (X @ b32)

        def rel(v, ref):
            return ((v.double() - ref).abs().max() / ref.abs().max()).item()

        line = {
            "n": n, "info": [int(info_c), int(info_b)],
            "cholesky_ex_ms": time_ms(lambda: torch.linalg.cholesky_ex(S32), 20,
                                      sleep, flush),
            "blocked_cholesky_ms": time_ms(lambda: linalg.blocked_cholesky(S32), 20,
                                           sleep, flush),
            "blocked_tril_inv_ms": time_ms(lambda: linalg.blocked_tril_inv(Lb), 20,
                                           sleep, flush),
            "cholesky_solve_ms": time_ms(
                lambda: torch.cholesky_solve(b32[:, None], Lc), 20, sleep, flush),
            "two_matvecs_ms": time_ms(lambda: X.T @ (X @ b32), 20, sleep, flush),
            "factor_rel_err": {"cholesky_ex": rel(Lc, L64), "blocked": rel(Lb, L64)},
            "solve_rel_err": {"cholesky_solve": rel(xc, x64),
                              "blocked_tril_inv": rel(xb, x64)},
            "blocked_vs_cholesky_ex": rel(Lb, Lc.double()),
        }
        emit({"phase": "blocked_chol", **line, "dtype": "float32", "block": 384,
              "timing": "median of 20, CUDA events, cold L2", "nvidia_smi": smi})
        check(line["info"] == [0, 0], f"blocked_chol n={n}: breakdown {line['info']}")
        for what, err in (*line["factor_rel_err"].items(),
                          *line["solve_rel_err"].items()):
            check(np.isfinite(err) and err < 1e-3,
                  f"blocked_chol n={n}: {what} relative error {err}")
        del L64, Lc, Lb, X, S32
        torch.cuda.empty_cache()
    emit({"phase": "blocked_chol_done", "phase_s": time.perf_counter() - t_phase})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; needs a GPU")
    if not PACKAGE.is_dir() or not P257.exists() or not P16.exists():
        sys.exit(f"chip_smoke: run from a checkout of the repository "
                 f"(missing {PACKAGE.name}/ or data/ beside {Path(__file__).name})")
    sys.path.insert(0, str(HERE))
    import flatline_campaign
    from bundleadjustment_benchmarks_tpu_torch import cli
    from bundleadjustment_benchmarks_tpu_torch.io import bal
    from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
    from bundleadjustment_benchmarks_tpu_torch.ops import (cuda_chain, cuda_graph,
                                                           jacobian, linalg)
    from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
    from bundleadjustment_benchmarks_tpu_torch.utils import balgen, checkpoint

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    bw, fp32 = card_rates(kind)
    op_rate = fp32 / 2  # float32 instructions per second, see OPS_PER_OBS
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "hbm_bytes_per_s": bw, "fp32_flop_per_s": fp32,
          "fp32_instr_per_s": op_rate})
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    # -- build: one nvcc per library, started together ---------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for built in [pool.submit(cuda_chain.load_library),
                      pool.submit(cuda_graph.load_library)]:
            built.result()
    ptxas = [ln.strip() for ln in cuda_chain.BUILD_INFO["ptxas"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(cuda_chain.NVCC_FLAGS), "ptxas": ptxas,
          "graph_cond_build_s": cuda_graph.BUILD_INFO["seconds"]})

    # -- kernels against their plain versions --------------------------------
    t0 = t_phase = time.perf_counter()
    problems = {name: pm.load_bal_problem(str(path), device=dev)
                for name, path in (("p16", P16), ("p257", P257))}
    load_s = time.perf_counter() - t0
    if sys.argv[1:] == ["--jit-only"]:  # the device-resident drive's phases
        n, m, k_real = LADYBUG
        ladybug = (balgen.generate_bal_like(n, m, seed=n, mean_degree=k_real / m), 0.0)
        jit_phases(pm, lm, cuda_chain, cuda_graph, problems, ladybug, smi)
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
        return
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(0)
    kern = {"chain_blocks": {"max_abs_err": 0.0, "energy_abs_err": 0.0},
            "chain_energy": {"max_abs_err": 0.0}}
    cases = []
    for name, prob in problems.items():
        tau2 = prob.tau2
        fast0 = pm.to_fast(prob.state)
        step = (torch.from_numpy(rng.normal(scale=1e-2, size=(prob.n_points, 3))),
                torch.from_numpy(rng.normal(scale=1e-3, size=(prob.n_cameras, 9))))
        fast1 = pm.apply_step_fast(fast0, *(s.to(dev) for s in step))
        for state_name, fast in (("loaded", fast0), ("perturbed", fast1)):
            ops = cuda_chain.chain_operands(fast, prob.obs)
            rows_k, eb_k = cuda_chain.launch("chain_blocks", ops, tau2)
            rows_p, eb_p = cuda_chain.chain_blocks_plain(fast, prob.obs, tau2)
            _, ee_k = cuda_chain.launch("chain_energy", ops, tau2)
            ee_p = cuda_chain.fused_energy_plain(fast, prob.obs, tau2)
            # Back to back on one stream: each launch finds the ticket that
            # the one before it reset.
            repeats = [cuda_chain.launch("chain_energy", ops, tau2)[1]
                       for _ in range(3)]
            repeats_b = [cuda_chain.launch("chain_blocks", ops, tau2)[1]
                         for _ in range(3)]
            repeats = [e.item() for e in repeats]
            repeats_b = [e.item() for e in repeats_b]
            torch.cuda.synchronize()
            rows_err = (rows_k - rows_p).abs().max().item()
            case = {
                "problem": name, "state": state_name, "K": prob.n_observations,
                "rows_equal": torch.equal(rows_k, rows_p),
                "rows_max_abs_err": rows_err,
                "rows_finite": bool(torch.isfinite(rows_k).all()),
                "blocks_energy": eb_k.item(),
                "blocks_energy_rel_err": abs(eb_k.item() - eb_p.item()) / abs(eb_p.item()),
                "energy": ee_k.item(),
                "energy_rel_err": abs(ee_k.item() - ee_p.item()) / abs(ee_p.item()),
                "energy_repeats_identical": len(set(repeats)) == 1
                and repeats[0] == ee_k.item(),
                "blocks_energy_repeats_identical": len(set(repeats_b)) == 1
                and repeats_b[0] == eb_k.item(),
            }
            kern["chain_blocks"]["max_abs_err"] = max(
                kern["chain_blocks"]["max_abs_err"], rows_err)
            kern["chain_blocks"]["energy_abs_err"] = max(
                kern["chain_blocks"]["energy_abs_err"],
                abs(eb_k.item() - eb_p.item()))
            kern["chain_energy"]["max_abs_err"] = max(
                kern["chain_energy"]["max_abs_err"], abs(ee_k.item() - ee_p.item()))
            if name == "p257" and state_name == "loaded":
                timed = time_entry_points(cuda_chain, fast, prob.obs, tau2, flush)
                case["blocks_ms"] = timed["chain_blocks"]["ms"]
                case["energy_ms"] = timed["chain_energy"]["ms"]
                case["blocks_plain_ms"] = time_ms(
                    lambda: cuda_chain.chain_blocks_plain(fast, prob.obs, tau2),
                    20, int(2e8), flush)
                case["energy_plain_ms"] = time_ms(
                    lambda: cuda_chain.fused_energy_plain(fast, prob.obs, tau2),
                    20, int(2e8), flush)
                k_obs, n, m = prob.n_observations, prob.n_cameras, prob.n_points
                bounds = kernel_bounds(n, m, k_obs, bw, op_rate)
                for which in kern:
                    kern[which].update(
                        bound_ms=bounds[which][0], bound_by=bounds[which][1],
                        **timed[which], **cuda_chain.launch_shape(which, n, k_obs))
                kern["chain_blocks"]["plain_ms"] = case["blocks_plain_ms"]
                kern["chain_energy"]["plain_ms"] = case["energy_plain_ms"]
            cases.append(case)
    emit({"phase": "kernels", "load_seconds": load_s, "cases": cases,
          "phase_s": time.perf_counter() - t_phase})
    for c in cases:
        where = f"{c['problem']}/{c['state']}"
        check(c["rows_finite"], f"{where}: non-finite rows")
        check(c["rows_equal"],
              f"{where}: rows differ from the plain version by {c['rows_max_abs_err']}")
        check(c["blocks_energy_rel_err"] <= ENERGY_RTOL,
              f"{where}: blocks energy rel err {c['blocks_energy_rel_err']}")
        check(c["energy_rel_err"] <= ENERGY_RTOL,
              f"{where}: energy rel err {c['energy_rel_err']}")
        check(c["energy_repeats_identical"] and c["blocks_energy_repeats_identical"],
              f"{where}: repeat launches gave different energies")
    for which, k in kern.items():
        check(k["kernels_per_call"] == 1 and k["empty_profiles"] <= 1,
              f"{which}: one entry-point call issued {k['kernels_per_call']} "
              f"device operations, not 1 ({k['empty_profiles']} of 3 "
              "profiles empty)")

    # -- main path, df32 drive with the kernels, p257 ---------------------------
    t_phase = time.perf_counter()
    p257 = problems["p257"]
    cfg = lm.LMConfig(max_iter=20, matmul_dtype="float32", geometry="df32")
    check(cfg.use_kernels(dev), "the df32 drive does not select the kernels")
    e0 = cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs, p257.tau2).item()
    lm.minimize(p257, mode="cholesky", config=lm.LMConfig(
        max_iter=2, matmul_dtype="float32", geometry="df32"))  # warm-up
    torch.cuda.synchronize()
    cuda_chain.reset_launches()
    t0 = time.perf_counter()
    res = lm.minimize(p257, mode="cholesky", config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_chain.LAUNCHES)
    # Stage times after the run, at its final state and lambda: median of 5,
    # each ending in a synchronize.
    fast = pm.to_fast(res.state)
    stage = {"prepare": [], "trial": []}
    for _ in range(5):
        t = time.perf_counter()
        ctx, _, _ = lm._prepare_fast(fast, p257, "cholesky", "float32",
                                     kernels=True)
        torch.cuda.synchronize()
        stage["prepare"].append(time.perf_counter() - t)
        t = time.perf_counter()
        lm._trial_fast(ctx, fast, res.lam, p257, "cholesky", "float32",
                       kernels=True)
        torch.cuda.synchronize()
        stage["trial"].append(time.perf_counter() - t)
    pts = res.state.points
    emit({"phase": "main_df32", "problem": "p257", "iterations": res.iterations,
          "fun_evals": res.fun_evals, "status": res.status.name,
          "initial_energy": e0, "final_energy": res.energy, "wall_s": wall,
          "lm_iter_per_s": res.iterations / wall,
          "prepare_ms_median": statistics.median(stage["prepare"]) * 1e3,
          "trial_ms_median": statistics.median(stage["trial"]) * 1e3,
          "launches": launches, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(np.isfinite(res.energy) and res.energy < e0,
          f"df32 p257: energy {res.energy} not finite and below {e0}")
    check(tuple(pts.shape) == (p257.n_points, 3) and bool(torch.isfinite(pts).all()),
          "df32 p257: final points not finite of shape (M, 3)")
    for which, count in launches.items():
        check(count > 0, f"{which} was not launched on the main path")
    kern["chain_blocks"]["launches"] = launches["chain_blocks"]
    kern["chain_energy"]["launches"] = launches["chain_energy"]

    # The same drive on p16 with the kernels and with the plain chain.
    t_phase = time.perf_counter()
    p16 = problems["p16"]
    runs = {}
    for kernels in (True, False):
        c = lm.LMConfig(max_iter=10, matmul_dtype="float32", geometry="df32",
                        kernels=kernels)
        runs[kernels] = lm.minimize(p16, mode="cholesky", config=c)
    gap = abs(runs[True].energy - runs[False].energy) / runs[False].energy
    emit({"phase": "main_df32_p16_kernels_vs_plain",
          "iterations": [runs[True].iterations, runs[False].iterations],
          "fun_evals": [runs[True].fun_evals, runs[False].fun_evals],
          "energy": [runs[True].energy, runs[False].energy], "rel_gap": gap,
          "phase_s": time.perf_counter() - t_phase})
    check(runs[True].iterations == runs[False].iterations and gap <= 1e-9,
          "df32 p16: kernel and plain chains took different LM paths")

    # -- main path, float64 drive, p16 ------------------------------------------
    t_phase = time.perf_counter()
    cfg64 = lm.LMConfig(max_iter=10)
    e0 = float(lm._prepare(p16.state, p16, "cholesky")[1])
    lm.minimize(p16, mode="cholesky", config=lm.LMConfig(max_iter=2))  # warm-up
    torch.cuda.synchronize()
    cuda_chain.reset_launches()
    t0 = time.perf_counter()
    res = lm.minimize(p16, mode="cholesky", config=cfg64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit({"phase": "main_f64", "problem": "p16", "iterations": res.iterations,
          "fun_evals": res.fun_evals, "status": res.status.name,
          "initial_energy": e0, "final_energy": res.energy, "wall_s": wall,
          "lm_iter_per_s": res.iterations / wall,
          "launches": dict(cuda_chain.LAUNCHES), "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(np.isfinite(res.energy) and res.energy < e0,
          f"f64 p16: energy {res.energy} not finite and below {e0}")

    # -- the other solver modes ---------------------------------------------------
    modes_phases(pm, lm, schur, jacobian, cuda_chain, problems, smi)

    # -- the command line ---------------------------------------------------------
    n, m, k_real = LADYBUG
    t0 = time.perf_counter()
    ladybug = (balgen.generate_bal_like(n, m, seed=n, mean_degree=k_real / m),
               time.perf_counter() - t0)
    for which, more in cli_phases(cli, pm, bal, balgen, checkpoint, cuda_chain,
                                  smi, flush, bw, op_rate, ladybug).items():
        kern[which].update(more)

    # -- the sharded path ---------------------------------------------------------
    for which, more in sharded_phases(pm, lm, sharded, multihost, cli, checkpoint,
                                      cuda_chain, problems, ladybug, smi).items():
        kern[which].update(more)

    # -- the flatline stop, the ellipse example, the blocked Cholesky pair ------
    flatline_phase(flatline_campaign, cuda_chain, smi)
    ellipse_phase(lm, smi)
    blocked_chol_phase(linalg, flush, smi)

    # -- the device-resident drive ------------------------------------------------
    for which, more in jit_phases(pm, lm, cuda_chain, cuda_graph, problems,
                                  ladybug, smi).items():
        kern[which].update(more)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    src = "bundleadjustment_benchmarks_tpu_torch/ops/csrc/chain_kernels.cu"
    replaces = {
        "chain_blocks": "bundleadjustment_benchmarks_tpu/ops/pallas_chain.py:83",
        "chain_energy": "bundleadjustment_benchmarks_tpu/ops/pallas_chain.py:98",
    }
    # max_abs_err: chain_blocks' rows, chain_energy's energy; the blocks
    # kernel's energy gap is its own field, energy_abs_err.
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "library_ms": None, **k}
        for name, k in kern.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

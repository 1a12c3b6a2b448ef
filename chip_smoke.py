"""Checks of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--jit-only]

Builds the kernels from ``bundleadjustment_benchmarks_tpu_torch/ops/csrc``
with nvcc, holds each chain kernel against its plain PyTorch version on the
in-repo BAL stand-ins and each of its entry points to one device operation
(in a CUDA graph of one call and in ``torch.profiler`` profiles), drives
``lm.minimize(mode="cholesky")`` on the df32 drive (kernels on, p257
stand-in) and on the float64 drive (p16 stand-in), both on the host LM
drive, then ``lm.minimize`` with ``LMConfig()``'s defaults, whose LM drive
is the device-resident one (one replay and one host read a run, as JAX's
one dispatch), against explicit jit and host runs on p257, float64 and
df32, and the graph cache's bound over p16, p126 and p257
(``default_drive``), float64 cholesky on p126 and p257 against the scipy
oracle's logged prefix on both LM drives (``oracle_prefix``),
``bench_torch.py``'s default run, bench.py's workload on p257 at 3
repeats, gated, each workload held to the JAX package's campaign row and
the scipy oracle's prefix, every iteration to the LM rules and every
accepted step and energy to float64 (``bench``), faults planted in those
rules and in the numbers caught by those two gates (``bench_planted``),
then the other four solver modes (``modes_df32_p257``, ``modes_f64_p16``),
every solve realization against cholesky's step (``modes_agree_p16``),
qrkit's "rows" and "pair" forms with their peak memory
(``qrkit_forms_p257``) and spqr's "gram" and "tsqr" forms
(``spqr_forms_p257``), then the command line in-process (``cli.main``):
p257 with ``--precision mixed``, a checkpoint and its resume
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
1 and 2 ranks (``dryrun_multichip``; the NCCL rank replays its captured
step), then every mode on p16 float64 to the reference's flatline stop,
each held to the JAX campaign's f64 budget against the scipy oracle
(``flatline_p16_f64``), the ellipse-fitting example on the card
(``ellipse``) and the blocked Cholesky pair against cuSOLVER's at the p257
and Ladybug reduced-system sizes (``blocked_chol``), then the
device-resident LM drive (``drive="jit"``): both kernels replayed from a
captured graph (``jit_kernels_replayed``), p257 df32 cholesky on both
drives alternated (``jit_p257_df32``), the chunk loop with no
synchronization between its reads (``jit_no_sync``), every mode
(``jit_modes``) and the Ladybug stand-in (``jit_ladybug_df32``), then the
block Jacobi eigensolver that pair-less qrkit's prepare runs, on its p16
and p257 grams and on rank-deficient and clustered matrices of 10 and
1,000 rows, against ``torch.linalg.eigh`` and replayed from a graph, with
its sweep counters (``eigh_capture``), qrkit without pair tables on both
drives, one eigensolver call a prepare (``jit_qrkit_rows_p257``), and the
sharded jit drive: NCCL at world size 1 against the sharded host drive and
the single-device jit drive (``jit_sharded_nccl_p257``,
``jit_sharded_no_sync``, ``jit_sharded_modes``), two NCCL ranks where the
machine has two GPUs (``jit_sharded_nccl_d2``; on one GPU a line says it
did not run), and the refusal of two gloo ranks on the card
(``jit_sharded_gloo_refused``, in the sharded gloo group), and fails on any
disagreement. ``--jit-only`` runs the build and the jit, eigensolver and
sharded jit phases alone. Each phase prints JSON lines with its wall time
(``phase_s``), the script's own cost; then come one line of per-kernel
results (the device operations one entry-point call issues, which must be
1 in a CUDA graph of one call and in every profile of 10 that records any,
the launch shape, the errors against the plain version and the launches
counted in the phases; the eigensolver's entry beside them), and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. It times nothing:
``stage_profile.py`` times the kernels and ``portbench/`` the solves.
Without a CUDA device, or without the package beside it, it exits non-zero
before printing any result. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import gzip
import hashlib
import io
import json
import re
import shutil
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


#: Host time kept inside each profile before the call and after its
#: synchronize (``device_ops_per_call``).
PROFILE_PAD_S = 2e-3
#: Profiles per entry point of the one-operation gate.
PROFILES = 10


def device_ops_per_call(fn, profiles: int = PROFILES) -> dict:
    """Device kernels and memory operations one call of ``fn`` issues, as
    ``torch.profiler`` records them in each of ``profiles`` profiles (after
    a warm-up call): ``kernels_per_call``, the count the profiles that
    recorded any device activity agree on (None where they disagree or
    none did), ``empty_profiles``, how many recorded none, and ``counts``.
    Each profile holds the host ``PROFILE_PAD_S`` seconds before the call
    and after its synchronize. A profile of one call still comes back empty
    now and then, padded or not (PERF.md, PR 11), so the gate counts the
    call's operations in a CUDA graph too (``graph_ops_per_call``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        counts.append(sum(e.device_type == DeviceType.CUDA
                          for e in prof.events()))
    seen = {c for c in counts if c}
    return {"kernels_per_call": seen.pop() if len(seen) == 1 else None,
            "empty_profiles": counts.count(0), "profiles": profiles,
            "counts": counts}


#: cuGraphNodeGetType's value of a kernel node (cuda.h).
CU_GRAPH_NODE_TYPE_KERNEL = 0


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h, CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("gridDimX", "gridDimY", "gridDimZ",
                                     "blockDimX", "blockDimY", "blockDimZ",
                                     "sharedMemBytes")] + [
        ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernel_names(raw_graph) -> list:
    """The function names of the kernel nodes of a ``cudaGraph_t`` (an
    int), read through the CUDA driver API, which knows every module's kernels
    whichever runtime launched them."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        err = getattr(cu, name)(*args)
        if err:
            raise RuntimeError(f"{name} failed: CUresult {err}")

    graph, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t()
    call("cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
             ctypes.byref(params))
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        names.append(name.value.decode())
    return names


def graph_ops_per_call(fn, which: str) -> dict:
    """One call of ``fn`` (an entry point of the chain kernel ``which``)
    captured into a CUDA graph on the port's capture stream, after a warm-up
    call there: ``graph_node_types``, its nodes by type
    (``cuda_graph.node_types``), ``graph_kernels``, the names of its kernel
    nodes, and ``graph_ops_per_call``, how many of them run ``which``'s
    kernel. While it captures, the wrapper adds one more kernel node of its
    own, the graph launch counter's increment (``cuda_chain.launch``), so
    one call that issues one device operation gives {"kernel": 2}."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, cuda_graph

    dev = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.stream(cuda_graph.capture_stream(dev)):
        cuda_chain.prepare_capture(dev)
        fn()
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin()
        fn()
        graph.capture_end()
    raw = graph.raw_cuda_graph()
    _, by_type = cuda_graph.node_types(raw)
    names = graph_kernel_names(raw)
    del graph
    return {"graph_node_types": by_type, "graph_kernels": names,
            "graph_ops_per_call": sum(f"{which}_kernel" in n for n in names)}


#: The float64 kernels against the plain float64 chain: the rows bit for bit
#: (projection.ordered_bmm sums the small products in the kernel's order),
#: the energies, summed in other orders, within this.
F64_ENERGY_RTOL = 1e-13


def f64_kernels_case(cuda_chain, state, prob) -> dict:
    """The float64 pair at ``state`` against the plain chain
    (``chain_blocks_f64_plain``, ``projection.energy``): the rows equal, and
    their largest gap over each row's largest magnitude, the energies'
    relative gaps, and three more launches of each, back to back, equal bit
    for bit."""
    from bundleadjustment_benchmarks_tpu_torch.ops import projection

    ops = cuda_chain.f64_operands(state, prob.obs)

    def both():
        rows, eb = cuda_chain.launch_f64("chain_blocks_f64", ops, prob.tau2)
        return rows, eb, cuda_chain.launch_f64("chain_energy_f64", ops, prob.tau2)[1]

    rows_k, eb_k, ee_k = both()
    repeats = [both() for _ in range(3)]
    rows_p, eb_p = cuda_chain.chain_blocks_f64_plain(state, prob.obs, prob.tau2)
    ee_p = projection.energy(state, prob.obs, prob.tau2)
    scale = rows_p.abs().amax(1, keepdim=True)
    return {"drive": "f64", "K": prob.n_observations,
            "rows_equal": torch.equal(rows_k, rows_p),
            "rows_rel_err": ((rows_k - rows_p).abs() / scale).max().item(),
            "rows_finite": bool(torch.isfinite(rows_k).all()),
            "blocks_energy": eb_k.item(),
            "blocks_energy_rel_err": abs(eb_k.item() / eb_p.item() - 1.0),
            "energy": ee_k.item(),
            "energy_rel_err": abs(ee_k.item() / ee_p.item() - 1.0),
            "repeats_identical": all(
                torch.equal(r, rows_k) and b.item() == eb_k.item()
                and e.item() == ee_k.item() for r, b, e in repeats)}


def entry_points(cuda_chain, fast, obs, tau2) -> dict:
    """Each df32 chain kernel's entry point on a FastBAState, called as the
    LM calls it: ``fused_blocks_energy`` / ``fused_energy``."""
    return {"chain_blocks": lambda: cuda_chain.fused_blocks_energy(fast, obs, tau2),
            "chain_energy": lambda: cuda_chain.fused_energy(fast, obs, tau2)}


def f64_entry_points(cuda_chain, state, obs, tau2) -> dict:
    """Each float64 chain kernel's entry point on a BAState, called as the
    LM calls it: ``blocks_energy_f64`` / ``energy_f64``."""
    return {"chain_blocks_f64": lambda: cuda_chain.blocks_energy_f64(state, obs, tau2),
            "chain_energy_f64": lambda: cuda_chain.energy_f64(state, obs, tau2)}


def entry_point_ops(entries: dict) -> dict:
    """Per chain kernel of ``entries`` ({kernel: its entry point}), the
    device operations one call issues: ``kernels_per_call`` and
    ``empty_profiles`` (``device_ops_per_call``) and the call in a CUDA
    graph (``graph_ops_per_call``)."""
    return {which: {**device_ops_per_call(fn), **graph_ops_per_call(fn, which)}
            for which, fn in entries.items()}


def drive_mode(lm, cuda_chain, prob, mode: str, max_iter: int,
               df32: bool) -> tuple:
    """``lm.minimize(mode)`` on the host drive with the chain kernels'
    launches and the peak device memory of the run. Returns (line,
    result)."""
    kw = dict(drive="host", **(DF32 if df32 else {}))
    torch.cuda.reset_peak_memory_stats()
    cuda_chain.reset_launches()
    res = lm.minimize(prob, mode=mode, config=lm.LMConfig(max_iter=max_iter, **kw))
    line = {"mode": mode, "iterations": res.iterations,
            "fun_evals": res.fun_evals, "status": res.status.name,
            "final_energy": res.energy,
            "launches": dict(cuda_chain.LAUNCHES),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
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
    "rows" and "pair" forms' peak memory over one prepare and one trial on
    p257, both drives; spqr's "gram" and "tsqr" camera steps on p257
    df32."""
    p257, p16 = problems["p257"], problems["p16"]
    t_phase = time.perf_counter()
    e0 = cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs, p257.tau2).item()
    lines = []
    for mode in ("qrchol", "moreqr", "qrkit", "spqr"):
        line, res = drive_mode(lm, cuda_chain, p257, mode, max_iter=5, df32=True)
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
        line, res = drive_mode(lm, cuda_chain, p16, mode, max_iter=10, df32=False)
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
                ctx, _, lam0 = lm._prepare_fast(x, prob, "qrkit", "float32",
                                                kernels=True)
                lm._trial_fast(ctx, x, float(lam0), prob, "qrkit", "float32",
                               kernels=True)
            else:
                ctx, _, lam0 = lm._prepare(x, prob, "qrkit")
                lm._trial(ctx, x, float(lam0), prob, "qrkit")
            emit({"phase": "qrkit_forms_p257", "drive": "df32" if df32 else "f64",
                  "form": form, "lambda": float(lam0),
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "nvidia_smi": smi})
            del ctx
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
    for form in ("gram", "tsqr"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if form == "gram":
            dxc = schur.camera_solve_qr(ctx, lam, p257)
        else:
            dxc = schur._camera_solve_tsqr(ctx, lam, p257, Linv,
                                           mm_dtype=torch.float32)
        steps[form] = dxc.double()
        emit({"phase": "spqr_forms_p257", "drive": "df32", "form": form,
              "lambda": lam,
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


def ladybug_standin(balgen):
    """The generated stand-in of BAL's Ladybug problem (a BalDataset)."""
    n, m, k = LADYBUG
    return balgen.generate_bal_like(n, m, seed=n, mean_degree=k / m)


def run_cli(cli, args) -> tuple:
    """``cli.main(args)`` in this process; returns (return code, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in args])
    return rc, buf.getvalue()


def cli_summary(out: str, metrics: Path) -> dict:
    """What a CLI run printed: header, pre and post "True objective", status,
    iteration-table rows, and its JSONL records (``iterations_run``: the
    iterations that ran a trial)."""
    lines = out.splitlines()
    objective = [float(ln.split()[-1]) for ln in lines
                 if ln.startswith("True objective:")]
    rows = [int(m[1]) for m in map(CLI_ROW.match, lines) if m]
    records = ([json.loads(ln) for ln in metrics.read_text().splitlines()]
               if metrics.exists() else [])
    iterations = len({(r.get("phase"), r["iter"]) for r in records})
    return {"header": lines[0], "objective_pre": objective[0],
            "objective_post": objective[-1],
            "status": next(ln.split(": ", 1)[1] for ln in lines
                           if ln.startswith("LM finished with status")),
            "table_rows": len(rows), "first_row_iter": rows[0] if rows else None,
            "records": len(records), "iterations_run": iterations,
            "resumed": any(ln.startswith("Resuming from") for ln in lines)}


def cli_phases(cli, pm, bal, balgen, checkpoint, cuda_chain, smi,
               ladybug) -> dict:
    """The command line on the card, in-process, its log, metrics and
    checkpoints in a temporary directory. Each run's chain-kernel launches
    are counted from 0. ``ladybug`` is the generated stand-in's BalDataset.
    Returns per kernel the CLI phases' launch counts and the Ladybug
    stand-in's kernel numbers."""
    extra = {"chain_blocks": {}, "chain_energy": {}}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        log = ["--log-file", tmp / "run.log"]

        # -- p257, mixed: 10 iterations, checkpoint every 5, then resume; the
        # same 10 iterations without the table and the checkpoints, and with
        # the table alone ----------------------------------------------------
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
            for which in cuda_chain.DRIVE_KERNELS["df32"]:
                check(run["launches"][which] > 0,
                      f"cli_mixed_p257 {run['run']}: {which} not launched")
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
        check(all(launches[k] > 0 for k in cuda_chain.DRIVE_KERNELS["df32"]),
              "cli_f64_p16 polish: the fast phase did not launch both kernels")
        check(all(launches[k] > 0 for k in cuda_chain.DRIVE_KERNELS["f64"]),
              "cli_f64_p16 polish: the float64 phase did not launch its kernels")

        # -- Ladybug stand-in, mixed: cameras past the shared-memory stage ------
        t_phase = time.perf_counter()
        n, m, _ = LADYBUG
        path = tmp / "problem-1723-156502-pre-standin.txt.gz"
        balgen.write_bal_gz(str(path), ladybug)
        k_obs = ladybug.n_observations
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
        for which in cuda_chain.DRIVE_KERNELS["df32"]:
            check(launches[which] > 0, f"cli_ladybug_df32: {which} not launched")
            extra[which]["launches_cli_ladybug_df32"] = launches[which]

        # Both kernels at this K against their plain versions.
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
        for which in extra:
            extra[which]["ladybug"] = {
                "n_cameras": n, "K": k_obs,
                "max_abs_err": errs[which], "energy_rel_err": gaps[which],
                **cuda_chain.launch_shape(which, n, k_obs)}
        emit({"phase": "cli_ladybug_df32",
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
    problem, mode, iters, config; optionally warmup, bytes, checkpoint,
    refused: the run must raise ValueError, whose message is its line)
    through ``sharded.minimize_sharded``, after an optional one-iteration
    warm-up (where the jit drive captures), with this rank's chain-kernel
    launches and peak
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
        if run["problem"] not in shards:
            shards[run["problem"]] = sharded.shard_problem(
                problems[run["problem"]], n, rank, device=device)
        sp = shards[run["problem"]]
        cfg = lm.LMConfig(max_iter=run["iters"],
                          **{"drive": "host", **run.get("config", {})})
        if run.get("refused"):  # a run that must raise ValueError
            try:
                sharded.minimize_sharded(sp, run["mode"], cfg)
                message = None
            except ValueError as e:
                message = str(e)
            out.append({"run": run["name"], "rank": rank, "refused": message})
            continue
        if run.get("warmup"):
            sharded.minimize_sharded(sp, run["mode"], dataclasses.replace(cfg, max_iter=1))
        observe = (dict(checkpoint_path=checkpoint_path, checkpoint_every=2)
                   if run.get("checkpoint") else {})
        torch.cuda.reset_peak_memory_stats(device)
        cuda_chain.reset_launches()
        res = sharded.minimize_sharded(sp, run["mode"], cfg, **observe)
        line = {"run": run["name"], "rank": rank, "shards": n,
                "backend": dist.get_backend(), "problem": run["problem"],
                "mode": run["mode"], "drive": "df32" if cfg.geometry else "f64",
                "observations": sp.problem.n_observations,
                "points": sp.problem.n_points,
                "iterations": res.iterations, "fun_evals": res.fun_evals,
                "status": res.status.name, "final_energy": res.energy,
                "lam": res.lam,
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
        cfg = lm.LMConfig(max_iter=run["iters"],
                          **{"drive": "host", **run.get("config", {})})
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
                                    "final_energy")},
            **{k: lead[k] for k in ("allreduce_per_prepare", "allreduce_per_trial")
               if k in lead},
            "initial_energy": e0.get(lead["problem"]),
            "ranks_agree": all([r[k] for k in keys] == [lead[k] for k in keys]
                               for r in per_rank),
            "launches_per_rank": [r["launches"] for r in per_rank],
            "observations_per_rank": [r["observations"] for r in per_rank],
            "max_memory_allocated_per_rank": [r["max_memory_allocated"]
                                              for r in per_rank],
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
                config=DF32, bytes=True)
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
    lady = pm.from_bal_dataset(ladybug, device="cuda")
    e0["ladybug"] = cuda_chain.fused_energy(pm.to_fast(lady.state), lady.obs,
                                            lady.tau2).item()
    local = {"p257": portable(p257), "p16": portable(problems["p16"]),
             "ladybug": portable(lady)}
    five = dict(name="cholesky_5", problem="p257", mode="cholesky", iters=5,
                config=DF32, bytes=True)
    modes = [dict(name=f"{mode}_3", problem="p257", mode=mode, iters=3,
                  config=DF32) for mode in MODES]
    f64 = [dict(name=f"{mode}_f64", problem="p16", mode=mode, iters=5)
           for mode in MODES]
    ck_run = dict(name="checkpoint", problem="p257", mode="cholesky", iters=4,
                  config=DF32, checkpoint=True)
    refused = dict(name="jit_refused", problem="p16", mode="cholesky", iters=2,
                   config={"drive": "jit"}, refused=True)
    lady_run = dict(name="ladybug", problem="ladybug", mode="cholesky", iters=2,
                    config=DF32, bytes=True)
    single = single_runs(lm, {**problems, "ladybug": lady},
                         [five] + modes + f64 + [lady_run])
    del lady
    torch.cuda.empty_cache()
    groups = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        ck = str(Path(tmp_name) / "d2.ckpt.npz")
        for d, runs in ((2, [refused, five] + modes + f64 + [ck_run, lady_run]),
                        (4, [five])):
            lines = multihost.run_ranks(sharded_rank, ["cuda:0"] * d,
                                        args=(local, runs, ck), timeout=600)
            refusals = [ln["refused"] for rank_lines in lines for ln in rank_lines
                        if "refused" in ln]
            if refusals:
                emit({"phase": "jit_sharded_gloo_refused", "ranks": d,
                      "messages": refusals, "nvidia_smi": smi})
                check(len(refusals) == d and all(m and "NCCL" in m for m in refusals),
                      f"jit_sharded_gloo_refused: {refusals}")
            lines = [[ln for ln in rank_lines if "refused" not in ln]
                     for rank_lines in lines]
            groups[d] = summarize(lines, single, e0)
        state, meta = checkpoint.load_checkpoint(ck, device="cuda")
    resumed = lm.minimize(p257, "cholesky",
                          lm.LMConfig(drive="host", max_iter=6, **DF32),
                          state=state, resume=meta)
    for d, group in groups.items():
        for name, run in group.items():
            phase = {"p257": "sharded_gloo_p257", "p16": "sharded_f64_p16",
                     "ladybug": "sharded_ladybug_df32"}[run["problem"]]
            tol = SHARDED_F64_RTOL if run["drive"] == "f64" else SHARDED_DF32_RTOL
            tolerances = ({"tolerance": tol} if run["drive"] == "f64" else {
                "tolerance_first_trial": {"energy": SHARDED_PREPARE_RTOL,
                                          "lambda0": SHARDED_LAMBDA_RTOL,
                                          "trial_energy": tol}})
            emit({"phase": phase, "run": name, **run, **tolerances,
                  "nvidia_smi": smi})
            where = f"{phase} {name} D={d}"
            check(run["backend"] == "gloo", f"{where}: backend {run['backend']}")
            check(run["ranks_agree"], f"{where}: the ranks disagree")
            check(np.isfinite(run["final_energy"])
                  and run["final_energy"] < run["initial_energy"],
                  f"{where}: energy {run['final_energy']} not below "
                  f"{run['initial_energy']}")
            for launches in run["launches_per_rank"]:
                check(all(launches[k] > 0
                          for k in cuda_chain.DRIVE_KERNELS[run["drive"]]),
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
    emit({"phase": "sharded_gloo_done",
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
    check(all(launches[k] > 0 for k in cuda_chain.DRIVE_KERNELS["df32"]),
          "cli_shards: a kernel not launched")
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
    check(runs["n1"]["captured"] and not runs["n2"]["captured"],
          "dryrun_multichip: NCCL did not replay a captured step, or gloo did")
    for name, run in runs.items():
        check(all(c > 0 for c in run["launches"].values()),
              f"dryrun_multichip {name}: a configuration launched no kernel: "
              f"{run['launches']}")
    return extra


#: The jit drive against the host drive: energies within this relative gap
#: where both take the same LM path; where float32 rounding parts the paths
#: (atomic sums run in another order from run to run), one captured prepare
#: and trial at AGREE_LAMBDA_FACTOR x lambda0 against the eager one within
#: JIT_TRIAL_RTOL (the sharded path's gate), and descent.
JIT_RTOL = 1e-9
JIT_TRIAL_RTOL = 2e-3


def counted_minimize(lm, cuda_chain, prob, mode, cfg, minimize=None) -> dict:
    """One lm.minimize (or ``minimize(prob, mode, cfg)``): result, peak
    allocated bytes, reserved bytes after, chain launches and (jit) the
    drive's counters."""
    cuda_chain.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = (minimize or lm.minimize)(prob, mode, cfg)
    return {"res": res,
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


def reads_and_trials(lm, res) -> tuple:
    """(host reads, trials) a jit run of result ``res`` that nothing
    observed should show: one read (one dispatch, JAX's default), and a
    trial for every evaluation that was not an iteration's prepare."""
    started = res.iterations - (res.status in (
        lm.LMStatus.MaxItersReached, lm.LMStatus.TooManyFunctionEvaluation))
    return 1, res.fun_evals - started


def summary(run: dict) -> dict:
    res = run["res"]
    out = {"iterations": res.iterations, "fun_evals": res.fun_evals,
           "status": res.status.name, "energy": res.energy,
           **{k: run[k] for k in ("peak_bytes", "reserved_bytes", "launches")}}
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
    peaks) and ``jit_no_sync`` (a ``chunked=True`` run of the cached graph
    under ``torch.cuda.set_sync_debug_mode("error")`` between its reads:
    one read and one replay per chunk of 16 iterations).
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
        check(case["launches_3_replays_2_taken"] == {
            "chain_blocks": 2, "chain_energy": 2, "chain_blocks_f64": 0,
            "chain_energy_f64": 0},
              f"jit_kernels_replayed {name}: counted {case['launches_3_replays_2_taken']}")
    emit({"phase": "jit_kernels_replayed", "cases": cases, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})

    # -- jit_p257_df32 ---------------------------------------------------------
    t_phase = time.perf_counter()
    p257 = problems["p257"]
    kw = dict(matmul_dtype="float32", geometry="df32")
    e0 = cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs, p257.tau2).item()
    reserved0 = torch.cuda.memory_reserved()
    warm = {d: counted_minimize(lm, cuda_chain, p257, "cholesky",
                              lm.LMConfig(drive=d, max_iter=2, **kw))
            for d in ("host", "jit")}
    capture = dict(warm["jit"]["jit"],
                   reserved_by_capture=torch.cuda.memory_reserved() - reserved0)
    runs = {"host": [], "jit": []}
    for drive in ("host", "jit", "jit", "host", "host", "jit"):
        runs[drive].append(counted_minimize(
            lm, cuda_chain, p257, "cholesky",
            lm.LMConfig(drive=drive, max_iter=20, **kw)))
    gate = hold_jit(lm, p257, "cholesky", lm.LMConfig(max_iter=20, **kw),
                    runs["host"][0], runs["jit"][0], e0, "jit_p257_df32")
    jit_launches = runs["jit"][0]["launches"]
    emit({"phase": "jit_p257_df32", "mode": "cholesky", "initial_energy": e0,
          "capture": capture, **gate,
          "host": [summary(r) for r in runs["host"]],
          "jit": [summary(r) for r in runs["jit"]],
          "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase})
    for which in cuda_chain.DRIVE_KERNELS["df32"]:
        check(jit_launches[which] > 0,
              f"jit_p257_df32: {which} not launched in the graph")
        extra[which]["launches_jit_p257_df32"] = jit_launches[which]
    for r in runs["jit"]:
        reads, trials = reads_and_trials(lm, r["res"])
        check((r["jit"]["reads"], r["jit"]["replays"], r["jit"]["slots"])
              == (reads, reads, trials),
              f"jit_p257_df32: {r['jit']} for {r['res'].iterations} iterations, "
              f"{r['res'].fun_evals} evaluations")

    # -- jit_no_sync -------------------------------------------------------------
    t_phase = time.perf_counter()
    # Chunked: the graph of the one-dispatch runs above replayed per chunk.
    cfg = lm.LMConfig(drive="jit", max_iter=20, chunked=True, **kw)
    prepare, trial, to_loop, _ = lm.step_functions(p257, "cholesky", cfg, dev)
    x0 = to_loop(p257.state)
    loop, capture_s = lm._device_loop(p257, "cholesky", cfg, x0, dev, prepare, trial)
    loop.reads = loop.replays = 0
    _, status, it, fun_evals, energy, _ = loop.run(x0, sync_debug=True,
                                                   config=cfg)
    torch.cuda.synchronize()
    started = it - (status in (lm.LMStatus.MaxItersReached,
                               lm.LMStatus.TooManyFunctionEvaluation))
    chunks = -(-started // cfg.chunk_size)
    emit({"phase": "jit_no_sync", "iterations": it, "fun_evals": fun_evals,
          "status": status.name, "energy": energy, "reads": loop.reads,
          "replays": loop.replays, "chunks": chunks,
          "captured_here": capture_s > 0, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(capture_s == 0.0, "jit_no_sync: the p257 graph was not cached")
    check(loop.chunked and loop.reads == loop.replays == chunks > 1,
          f"jit_no_sync: {loop.reads} reads, {loop.replays} replays for "
          f"{started} iterations started in chunks of {cfg.chunk_size}")
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
            cfg = lm.LMConfig(drive="host", max_iter=iters, **kw_mode)
            if kw_mode:
                e0_m = cuda_chain.fused_energy(pm.to_fast(prob.state), prob.obs,
                                               prob.tau2).item()
            else:
                e0_m = float(lm._prepare(prob.state, prob, mode)[1])
            lm.minimize(prob, mode, dataclasses.replace(cfg, drive="jit",
                                                        max_iter=1))
            capture = dict(lm.LAST_JIT_RUN)
            host = counted_minimize(lm, cuda_chain, prob, mode, cfg)
            jit = counted_minimize(lm, cuda_chain, prob, mode,
                                 dataclasses.replace(cfg, drive="jit"))
            gate = hold_jit(lm, prob, mode, cfg, host, jit, e0_m,
                            f"jit_modes {name} {mode}")
            reads, trials = reads_and_trials(lm, jit["res"])
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
    lady = pm.from_bal_dataset(ladybug, device=dev)
    e0 = cuda_chain.fused_energy(pm.to_fast(lady.state), lady.obs, lady.tau2).item()
    reserved0 = torch.cuda.memory_reserved()
    lm.minimize(lady, "cholesky", lm.LMConfig(drive="jit", max_iter=1, **kw))
    capture = dict(lm.LAST_JIT_RUN,
                   reserved_by_capture=torch.cuda.memory_reserved() - reserved0)
    cfg = lm.LMConfig(drive="host", max_iter=3, **kw)
    host = counted_minimize(lm, cuda_chain, lady, "cholesky", cfg)
    jit = counted_minimize(lm, cuda_chain, lady, "cholesky",
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



# -- the capturable eigensolver and pair-less qrkit on the jit drive ------------

#: eigh_capture: the block Jacobi eigensolver (``cuda_eigh.jacobi_eigh``)
#: against ``torch.linalg.eigh`` on the grams that pair-less qrkit's prepare
#: factors: eigenvalues within EIGH_RTOL of max|w| and ||C^T C - S|| / ||S||
#: within EIGH_RTOL (C = sqrt(max(w, 0)) V^T, the gram square root), in
#: float64; the float32 gram of the df32 drive to EIGH_RTOL_F32 (the
#: kernels run in float64, the result is rounded to float32).
EIGH_RTOL = 1e-12
EIGH_RTOL_F32 = 1e-5
#: eigh_capture's matrices beside the grams: PSD, shaped like them, of sizes
#: that are no multiple of the kernels' padding (n = 10 is below one block
#: pair): a 7-dimensional null space under noise of 1e-16 of the norm, and a
#: quarter of the eigenvalues within 1e-10 of 1 (``gram_like``).
EIGH_SYNTHETIC = (("null7", 10), ("null7", 1000), ("cluster", 1000))


@contextlib.contextmanager
def recorded_grams(cuda_eigh, grams: list):
    """Append every matrix ``cuda_eigh.eigh`` is given to ``grams``."""
    eigh = cuda_eigh.eigh

    def recording(S):
        grams.append(S.clone())
        return eigh(S)

    cuda_eigh.eigh = recording
    try:
        yield
    finally:
        cuda_eigh.eigh = eigh


def qrkit_gram(pm, lm, cuda_eigh, prob, df32: bool) -> torch.Tensor:
    """The camera gram that qrkit's prepare hands the eigensolver on
    ``prob`` without its pair tables: float64, or on the df32 drive the
    float32 one."""
    prob = no_pairs(prob)
    grams = []
    with recorded_grams(cuda_eigh, grams):
        if df32:
            lm._prepare_fast(pm.to_fast(prob.state), prob, "qrkit", "float32",
                             kernels=True)
        else:
            lm._prepare(prob.state, prob, "qrkit")
    return grams[0]


def eigh_gaps(S, w, V) -> dict:
    """Eigenvalue gap to ``torch.linalg.eigh`` relative to max|w|, and
    ||C^T C - S|| / ||S|| of the gram square root, in float64."""
    S64, w64, V64 = S.double(), w.double(), V.double()
    ref = torch.linalg.eigh(S64)[0]
    C = torch.sqrt(torch.clamp(w64, min=0.0))[:, None] * V64.T
    err = (w64 - ref).abs().max()
    return {"eigenvalue_gap": (err / ref.abs().max()).item(),
            "eigenvalue_abs_err": err.item(),
            "gram_gap": ((C.T @ C - S64).norm() / S64.norm()).item()}


def gram_like(case: str, n: int) -> torch.Tensor:
    """A float64 PSD matrix shaped like qrkit's camera grams, from numpy's
    seed n, on the card: "null7" has a 7-dimensional null space (bundle
    adjustment's gauge) under symmetric noise of 1e-16 of its norm, so it
    is indefinite at that level; "cluster" has a quarter of its eigenvalues
    within 1e-10 of 1 among others spread over [1e-3, 10].
    ``tests/test_torch_cuda.py`` takes its matrices from here."""
    rng = np.random.default_rng(n)
    if case == "null7":
        G = rng.normal(size=(n, max(n - 7, 1)))
        S = G @ G.T / n
        E = rng.normal(size=(n, n))
        S = S + 1e-16 * np.linalg.norm(S) * (E + E.T) / (2 * n)
    else:
        Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        w = 10.0 ** rng.uniform(-3, 1, size=n)
        k = max(n // 4, 2)
        w[:k] = 1.0 + 1e-10 * np.arange(k)
        S = (Q * w) @ Q.T
    return torch.from_numpy((S + S.T) / 2).to("cuda")


def eigh_counts(cuda_eigh, S) -> dict:
    """The kernels' counters of one call, per outer sweep: pair solves that
    rotated, inner sweeps run and rotations."""
    stats = torch.zeros((cuda_eigh.MAX_SWEEPS, 3), dtype=torch.int32, device=S.device)
    sweeps = int(cuda_eigh.jacobi_eigh(S, stats=stats)[3])
    rows = stats[:sweeps].tolist()
    return {"pairs_rotated": [r[0] for r in rows], "inner_sweeps": [r[1] for r in rows],
            "rotations": [r[2] for r in rows]}


def eigh_phases(pm, lm, cuda_chain, cuda_eigh, cuda_graph, problems,
                smi) -> dict:
    """``eigh_capture``: the block Jacobi eigensolver on the grams that
    qrkit's prepare factors without pair tables (``qrkit_gram``; p16: n =
    145, p257: n = 2,314, float64; p257's float32 gram of the df32 drive)
    and on the ``EIGH_SYNTHETIC`` matrices, against ``torch.linalg.eigh``,
    and replayed from a graph inside a conditional body (equal to the eager
    call bit for bit); per case the counters per outer sweep
    (``eigh_counts``). ``jit_qrkit_rows_p257``: qrkit on p257 without its
    pair tables on the jit drive takes the host drive's path, df32 and
    float64, and calls the kernels once a prepare on both drives. A
    ``cuda_eigh`` without its launch counter and sweep statistics (an older
    checkout's) is checked without them. Returns the eigensolver's entry of
    the ``kernels`` line: the p257 float64 gram's numbers, and the calls the
    jit drive made in ``jit_qrkit_rows_p257`` at float64."""
    counted = hasattr(cuda_eigh, "LAUNCHES")
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    matrices = [(name, df32, qrkit_gram(pm, lm, cuda_eigh, problems[name], df32))
                for name, df32 in (("p16", False), ("p257", False), ("p257", True))]
    matrices += [(f"{case} n={n}", False, gram_like(case, n))
                 for case, n in EIGH_SYNTHETIC]
    cases = []
    for name, df32, S in matrices:
        w, V, info, sweeps = cuda_eigh.jacobi_eigh(S)
        graph = cuda_graph.DeviceGraph(dev)
        with torch.cuda.stream(graph.stream):
            if counted:
                cuda_eigh.prepare_capture(dev)
            cuda_eigh.jacobi_eigh(S)
        pred = torch.ones((), dtype=torch.bool, device=dev)
        out = {}

        def body():
            out["w"], out["V"], out["info"], _ = cuda_eigh.jacobi_eigh(S)

        graph.capture(lambda: cuda_graph.device_if(pred, body))
        graph.replay()
        torch.cuda.synchronize()
        case = {"problem": name, "drive": "df32" if df32 else "f64", "n": S.shape[0],
                "dtype": str(S.dtype), "info": int(info), "sweeps": int(sweeps),
                "max_sweeps": cuda_eigh.MAX_SWEEPS, **eigh_gaps(S, w, V),
                "plain": eigh_gaps(S, *torch.linalg.eigh(S)),
                "replay_equal_eager": torch.equal(out["w"], w) and torch.equal(out["V"], V)
                and int(out["info"]) == int(info),
                "graph_node_types": graph.node_types}
        graph.close()
        if counted:
            case["per_sweep"] = eigh_counts(cuda_eigh, S)
        cases.append(case)
        emit({"phase": "eigh_capture", **case, "nvidia_smi": smi})
        tol = EIGH_RTOL_F32 if df32 else EIGH_RTOL
        where = f"eigh_capture {name} {case['drive']}"
        check(case["info"] == 0, f"{where}: no convergence in {case['sweeps']} sweeps")
        check(case["eigenvalue_gap"] <= tol and case["gram_gap"] <= tol,
              f"{where}: {case['eigenvalue_gap']}, {case['gram_gap']} above {tol}")
        check(case["replay_equal_eager"], f"{where}: the replay differs from eager")
        check(not counted or (case["per_sweep"]["rotations"][-1:] == [0]
                              and len(case["per_sweep"]["rotations"]) == case["sweeps"]),
              f"{where}: the counters {case.get('per_sweep')} disagree with the sweeps")
    emit({"phase": "eigh_capture_done", "phase_s": time.perf_counter() - t_phase})

    t_phase = time.perf_counter()
    prob = no_pairs(problems["p257"])
    for kw in (DF32, {}):
        cfg = lm.LMConfig(max_iter=2, **kw)
        lm.minimize(prob, "qrkit", dataclasses.replace(cfg, drive="jit", max_iter=1))
        capture = dict(lm.LAST_JIT_RUN)
        runs, eigh_calls = {}, {}
        for drive in ("host", "jit"):
            if counted:
                cuda_eigh.reset_launches()
            runs[drive] = counted_minimize(lm, cuda_chain, prob, "qrkit",
                                         dataclasses.replace(cfg, drive=drive))
            if counted:
                eigh_calls[drive] = cuda_eigh.LAUNCHES["jacobi_eigh"]
        host, jit = runs["host"], runs["jit"]
        h, j = host["res"], jit["res"]
        gap = abs(j.energy - h.energy) / abs(h.energy)
        reads, trials = reads_and_trials(lm, j)
        prepares = jit["jit"]["prepares"]
        emit({"phase": "jit_qrkit_rows_p257", "drive": "df32" if kw else "f64",
              "capture": capture, "host": summary(host), "jit": summary(jit),
              "energy_rel_gap": gap, "tolerance": NCCL_RTOL,
              "jacobi_eigh_launches": eigh_calls, "prepares": prepares,
              "nvidia_smi": smi})
        where = f"jit_qrkit_rows_p257 {'df32' if kw else 'f64'}"
        check(not counted or eigh_calls == {"host": prepares, "jit": prepares},
              f"{where}: {eigh_calls} eigensolver calls, not one for each of "
              f"{prepares} prepares")
        check((h.iterations, h.fun_evals, h.status) == (j.iterations, j.fun_evals, j.status)
              and gap <= NCCL_RTOL, f"{where}: host {h}, jit {j}")
        check((jit["jit"]["reads"], jit["jit"]["slots"]) == (reads, trials),
              f"{where}: {jit['jit']}")
        lm.clear_graphs()
    emit({"phase": "jit_qrkit_rows_p257_done", "phase_s": time.perf_counter() - t_phase})
    gram = next(c for c in cases if c["problem"] == "p257" and c["drive"] == "f64")
    return {"name": "jacobi_eigh", "route": "cuda",
            "source": "bundleadjustment_benchmarks_tpu_torch/ops/csrc/eigh.cu",
            "replaces": "bundleadjustment_benchmarks_tpu/solvers/schur.py:938",
            "launches": eigh_calls.get("jit"),
            "max_abs_err": gram["eigenvalue_abs_err"],
            "n": gram["n"], "gram_gap": gram["gram_gap"]}


# -- the sharded jit drive ---------------------------------------------------------


def sharded_jit_rank(rank, device, problems, smi) -> dict:
    """The sharded jit drive in a group of one over NCCL (in this process):
    an eager all-reduce under sync debug "error", a conditional body
    holding one all-reduce, by node type; p257 df32
    cholesky, 20 iterations, sharded jit, sharded host and single-device
    jit alternated three times (``jit_sharded_nccl_p257``); the chunk loop
    under ``set_sync_debug_mode("error")`` (``jit_sharded_no_sync``); every
    mode at p257 df32 (5 iterations) and p16 float64 (10) on the three
    drives. Returns the lines to emit."""
    import torch.distributed as dist

    from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, cuda_graph
    from bundleadjustment_benchmarks_tpu_torch.parallel import sharded
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm

    out = {"backend": dist.get_backend()}
    t = torch.ones(8, device=device)
    dist.all_reduce(t)
    # An eager all-reduce's Work.wait() joins streams and does not block
    # the host (it would break a capture): sync debug mode "error" raises
    # on a synchronizing call.
    torch.cuda.set_sync_debug_mode("error")
    try:
        dist.all_reduce(t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph = cuda_graph.DeviceGraph(device)
    with torch.cuda.stream(graph.stream):
        dist.all_reduce(t)
    torch.cuda.synchronize(device)
    pred = torch.ones((), dtype=torch.bool, device=device)
    graph.capture(lambda: cuda_graph.device_if(pred, lambda: dist.all_reduce(t)))
    graph.replay()
    torch.cuda.synchronize(device)
    out["allreduce_body_node_types"] = graph.node_types
    out["allreduce_body_value"] = t[0].item()
    graph.close()

    shards = {name: sharded.shard_problem(prob, 1, rank, device=device)
              for name, prob in problems.items()}

    def run(kind, name, mode, cfg):
        if kind == "single_jit":
            return counted_minimize(lm, cuda_chain, problems[name], mode,
                                  dataclasses.replace(cfg, drive="jit"))
        drive = "jit" if kind == "sharded_jit" else "host"
        return counted_minimize(
            lm, cuda_chain, shards[name], mode, dataclasses.replace(cfg, drive=drive),
            minimize=lambda sp, m, c: sharded.minimize_sharded(sp, m, c))

    def sharded_graph():
        loops = [loop for key, (_, loop) in lm._GRAPHS.items() if key[-1] is not None]
        return loops[0]

    kinds = ("sharded_jit", "sharded_host", "single_jit")
    cfg = lm.LMConfig(max_iter=20, **DF32)
    # The sharded capture first, from an emptied cache: what it reserves is
    # its graph's pool.
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(device)
    warm = {k: run(k, "p257", "cholesky", dataclasses.replace(cfg, max_iter=2))
            for k in kinds[:1]}
    pool = torch.cuda.memory_reserved(device) - reserved0
    warm.update({k: run(k, "p257", "cholesky", dataclasses.replace(cfg, max_iter=2))
                 for k in kinds[1:]})
    loop = sharded_graph()
    capture = dict(warm["sharded_jit"]["jit"], node_types=loop.graph.node_types,
                   reserved_by_capture=pool)
    runs = {k: [] for k in kinds}
    for _ in range(3):
        for k in kinds:
            runs[k].append(run(k, "p257", "cholesky", cfg))
        kinds = kinds[::-1]
    out["p257"] = {"capture": capture,
                   **{k: [summary(r) for r in v] for k, v in runs.items()}}
    x0 = pm.to_fast(shards["p257"].problem.state)
    loop.reads = loop.replays = 0
    _, status, it, fun_evals, energy, _ = loop.run(x0, sync_debug=True, config=cfg)
    torch.cuda.synchronize(device)
    out["no_sync"] = {"iterations": it, "fun_evals": fun_evals,
                      "status": status.name, "energy": energy, "reads": loop.reads,
                      "replays": loop.replays}
    lm.clear_graphs()

    out["modes"] = []
    for name, iters, kw in (("p257", 5, DF32), ("p16", 10, {})):
        for mode in MODES:
            cfg = lm.LMConfig(max_iter=iters, **kw)
            for k in ("sharded_jit", "single_jit"):
                run(k, name, mode, dataclasses.replace(cfg, max_iter=1))
            out["modes"].append({"problem": name, "mode": mode,
                                 "drive": "df32" if kw else "f64",
                                 **{k: summary(run(k, name, mode, cfg))
                                    for k in ("sharded_jit", "sharded_host",
                                              "single_jit")}})
            lm.clear_graphs()
    return out


def jit_counts_ok(s: dict) -> bool:
    """One read and one replay for a jit run (its ``summary``) that nothing
    observed, and a trial counted on the device for every evaluation that
    was not a prepare."""
    started = s["iterations"] - (s["status"] in ("MaxItersReached",
                                                 "TooManyFunctionEvaluation"))
    return (s["reads"], s["replays"], s["slots"]) == (1, 1, s["fun_evals"] - started)


def same_path(runs: dict, tol: float) -> bool:
    """The summaries' iterations, evaluations and status are equal and
    their energies within ``tol`` of the first's."""
    first = next(iter(runs.values()))
    return all((r["iterations"], r["fun_evals"], r["status"])
               == (first["iterations"], first["fun_evals"], first["status"])
               and abs(r["energy"] - first["energy"]) <= tol * abs(first["energy"])
               for r in runs.values())


def sharded_jit_phases(lm, multihost, problems, smi) -> dict:
    """The sharded jit drive on the card: NCCL at world size 1 in this
    process (``jit_sharded_nccl_p257``, ``jit_sharded_no_sync``,
    ``jit_sharded_modes``, see ``sharded_jit_rank``) and, where the machine
    has two GPUs, two NCCL ranks (``jit_sharded_nccl_d2``). Returns per
    kernel its launches in the sharded jit p257 run."""
    t_phase = time.perf_counter()
    (out,) = multihost.run_ranks(sharded_jit_rank, ["cuda:0"], args=(problems, smi))
    p257 = out["p257"]
    emit({"phase": "jit_sharded_nccl_p257", "backend": out["backend"],
          "allreduce_body_node_types": out["allreduce_body_node_types"], **p257,
          "tolerance": NCCL_RTOL, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(out["backend"] == "nccl", f"jit_sharded_nccl_p257: backend {out['backend']}")
    check(out["allreduce_body_value"] == 1.0,
          "jit_sharded_nccl_p257: the replayed all-reduce of a group of one changed its input")
    for i in range(3):
        trio = {k: p257[k][i] for k in ("sharded_jit", "sharded_host", "single_jit")}
        check(same_path(trio, NCCL_RTOL),
              f"jit_sharded_nccl_p257 run {i}: paths differ {trio}")
        for k in ("sharded_jit", "single_jit"):
            check(jit_counts_ok(trio[k]), f"jit_sharded_nccl_p257 {k}: {trio[k]}")
        per = trio["sharded_jit"]
        check(per["allreduce_per_prepare"]["calls"] > 0
              and per["allreduce_per_trial"]["calls"] > 0,
              f"jit_sharded_nccl_p257: collectives {per}")
        for which in lm.cuda_chain.DRIVE_KERNELS["df32"]:
            check(per["launches"][which] > 0,
                  f"jit_sharded_nccl_p257: {which} not launched in the graph")
    no_sync = out["no_sync"]
    emit({"phase": "jit_sharded_no_sync", **no_sync, "nvidia_smi": smi})
    jit0 = p257["sharded_jit"][0]
    check((no_sync["iterations"], no_sync["fun_evals"], no_sync["status"])
          == (jit0["iterations"], jit0["fun_evals"], jit0["status"])
          and no_sync["energy"] == jit0["energy"]
          and no_sync["reads"] == no_sync["replays"] == 1,
          f"jit_sharded_no_sync: {no_sync} against {jit0}")
    for line in out["modes"]:
        emit({"phase": "jit_sharded_modes", **line, "tolerance": NCCL_RTOL,
              "nvidia_smi": smi})
        where = f"jit_sharded_modes {line['problem']} {line['mode']}"
        trio = {k: line[k] for k in ("sharded_jit", "sharded_host", "single_jit")}
        check(same_path(trio, NCCL_RTOL), f"{where}: paths differ {trio}")
        check(jit_counts_ok(line["sharded_jit"]), f"{where}: {line['sharded_jit']}")
    emit({"phase": "jit_sharded_nccl_done", "phase_s": time.perf_counter() - t_phase})

    t_phase = time.perf_counter()
    gpus = torch.cuda.device_count()
    if gpus < 2:
        emit({"phase": "jit_sharded_nccl_d2", "ran": False,
              "why": f"{gpus} GPU on this machine; NCCL refuses two ranks on one "
                     "GPU, so two NCCL ranks need two GPUs"})
    else:
        local = {"p16": portable(problems["p16"]), "p257": portable(problems["p257"])}
        runs = [dict(name=f"{drive}_{prob}", problem=prob, mode="cholesky", iters=iters,
                     config={**kw, "drive": drive}, warmup=True)
                for prob, iters, kw in (("p16", 10, {}), ("p257", 5, DF32))
                for drive in ("jit", "host")]
        lines = multihost.run_ranks(sharded_rank, ["cuda:0", "cuda:1"],
                                    args=(local, runs), deadline=600)
        group = summarize(lines, {}, {})
        emit({"phase": "jit_sharded_nccl_d2", "ran": True, **group, "nvidia_smi": smi,
              "phase_s": time.perf_counter() - t_phase})
        for prob in ("p16", "p257"):
            jit, host = group[f"jit_{prob}"], group[f"host_{prob}"]
            check(jit["backend"] == "nccl" and jit["ranks_agree"] and host["ranks_agree"],
                  f"jit_sharded_nccl_d2 {prob}: backend or rank agreement")
            check(same_path({"jit": {**jit, "energy": jit["final_energy"]},
                             "host": {**host, "energy": host["final_energy"]}},
                            NCCL_RTOL), f"jit_sharded_nccl_d2 {prob}: {jit} {host}")
    return {which: {"launches_jit_sharded_nccl_p257":
                    p257["sharded_jit"][0]["launches"][which]}
            for which in lm.cuda_chain.DRIVE_KERNELS["df32"]}


P16_ORACLE = HERE / "benchmarks" / "results" / "cpu_p16_flatline.json"


def flatline_phase(campaign, cuda_chain, smi) -> None:
    """``flatline_p16_f64``: every mode from the loaded p16 state to the
    flatline stop on the float64 drive (``flatline_campaign.run_row``: a
    2-iteration warm-up, then the timed run), each held to the JAX
    campaign's f64 budget (``flatline_campaign.BUDGETS``) against the scipy
    oracle's p16 flatline. The float64 drive launches the float64 chain
    kernels and no df32 one."""
    t_phase = time.perf_counter()
    budget = campaign.BUDGETS["f64"]
    oracle = json.loads(P16_ORACLE.read_text())["post"]
    problem, name = campaign.load_problem("p16", "cuda")
    for mode in MODES:
        row, state = campaign.run_row(problem, name, mode, "f64", device="cuda")
        verdict = campaign.budget_gaps(row["post"], oracle, budget)
        emit({"phase": "flatline_p16_f64",
              **{k: row[k] for k in ("mode", "status", "iterations", "fun_evals",
                                     "energy", "peak_bytes",
                                     "launches", "post")},
              "oracle": oracle, "budget": budget, **verdict, "nvidia_smi": smi})
        check(row["status"] in ("Success (Energy Flatlined)",
                                "Success (Exceeded Maximum Lambda)"),
              f"flatline_p16_f64 {mode}: stopped with {row['status']!r}")
        check(bool(torch.isfinite(state.points).all()),
              f"flatline_p16_f64 {mode}: points not finite")
        check(verdict["within"],
              f"flatline_p16_f64 {mode}: {verdict} outside {budget}")
        check(all(row["launches"][k] == 0 for k in cuda_chain.DRIVE_KERNELS["df32"])
              and all(row["launches"][k] > 0 for k in cuda_chain.DRIVE_KERNELS["f64"]),
              f"flatline_p16_f64 {mode}: the float64 drive launched {row['launches']}")
    emit({"phase": "flatline_p16_f64_done", "phase_s": time.perf_counter() - t_phase})


def same_state(a, b) -> bool:
    """Two BAStates equal bit for bit."""
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("K", "R", "T", "k1", "k2", "points"))


def default_drive_phase(pm, lm, cuda_chain, problems, p126, smi) -> dict:
    """``default_drive``: p257 cholesky with ``LMConfig()``'s defaults (20
    iterations), float64 and df32: the default takes the jit drive (a
    warm-up captures, every later run replays), equals an explicit
    ``drive="jit"`` run bit for bit and an explicit ``drive="host"`` run
    (float64: the same counts and energy, gap 0.0; df32: ``hold_jit``'s
    gate), the default and the host drive alternated (D, H, H, D, D, H).
    Then the graph cache's bound: the default float64 config
    (2 iterations) on p16, p126, p257 and p16 again, the cached entries and
    ``torch.cuda.memory_reserved()`` after each. Each default run's
    chain-kernel launches, counted from zero before it, are its own drive's
    pair alone: one blocks launch a prepare and one energy launch a trial.
    Returns the first default run's launches by drive ("f64", "df32"): the
    main path's."""
    t_phase = time.perf_counter()
    p257 = problems["p257"]
    launches = {}
    for name, kw in (("f64", {}), ("df32", DF32)):
        default = lm.LMConfig(max_iter=20, **kw)
        check(default.drive == "jit", f"default_drive: LMConfig().drive is "
              f"{default.drive!r}")
        host_cfg = dataclasses.replace(default, drive="host")
        lm.clear_graphs()
        lm.minimize(p257, "cholesky", dataclasses.replace(default, max_iter=2))
        capture = dict(lm.LAST_JIT_RUN)
        lm.minimize(p257, "cholesky", dataclasses.replace(host_cfg, max_iter=2))
        runs = {"default": [], "host": []}
        for d in ("default", "host", "host", "default", "default", "host"):
            runs[d].append(counted_minimize(lm, cuda_chain, p257, "cholesky",
                                          default if d == "default" else host_cfg))
        explicit = counted_minimize(lm, cuda_chain, p257, "cholesky",
                                  dataclasses.replace(default, drive="jit"))
        d0, h0, j = runs["default"][0]["res"], runs["host"][0]["res"], explicit["res"]
        line = {"phase": "default_drive", "problem": "p257", "mode": "cholesky",
                "drive": name, "capture": capture,
                "default": [summary(r) for r in runs["default"]],
                "host": [summary(r) for r in runs["host"]],
                "default_equals_explicit_jit": all(
                    same_state(r["res"].state, j.state) and r["res"].energy == j.energy
                    for r in runs["default"]),
                "host_rel_gap": abs(d0.energy - h0.energy) / abs(h0.energy),
                "host_state_equal": same_state(d0.state, h0.state),
                "nvidia_smi": smi}
        if kw:
            e0 = cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs,
                                         p257.tau2).item()
            line["gate"] = hold_jit(lm, p257, "cholesky", host_cfg, runs["host"][0],
                                    runs["default"][0], e0, "default_drive df32")
        launches[name] = line["launches"] = runs["default"][0]["launches"]
        emit(line)
        where = f"default_drive {name}"
        for r in runs["default"]:
            blocks, energy = cuda_chain.DRIVE_KERNELS[name]
            want = dict.fromkeys(cuda_chain.KERNELS, 0)
            want.update({blocks: r["jit"]["prepares"], energy: r["jit"]["slots"]})
            check(r["jit"]["prepares"] > 0 and r["launches"] == want,
                  f"{where}: launches {r['launches']}, not one {blocks} a "
                  f"prepare and one {energy} a trial ({r['jit']})")
        check(capture["captured"] and capture["replays"] > 0,
              f"{where}: the default config did not capture and replay ({capture})")
        check(all(r["jit"]["replays"] > 0 and not r["jit"]["captured"]
                  for r in runs["default"]),
              f"{where}: a default run did not replay the cached graph")
        check(all(r["jit"]["reads"] == r["jit"]["replays"] == 1
                  and r["jit"]["chunked"] is False for r in runs["default"]),
              f"{where}: an unobserved default run read more than once "
              f"({[r['jit'] for r in runs['default']]})")
        check(line["default_equals_explicit_jit"],
              f"{where}: the default differs from an explicit jit run")
        check((d0.iterations, d0.fun_evals, d0.status)
              == (h0.iterations, h0.fun_evals, h0.status),
              f"{where}: default {d0}, host {h0}")
        if not kw:
            check(line["host_rel_gap"] == 0.0,
                  f"{where}: default and host {line['host_rel_gap']} apart")
    lm.clear_graphs()

    cache = []
    small = dataclasses.replace(lm.LMConfig(), max_iter=2)
    for name, prob in (("p16", problems["p16"]), ("p126", p126),
                       ("p257", p257), ("p16", problems["p16"])):
        lm.minimize(prob, "cholesky", small)
        torch.cuda.synchronize()
        cache.append({"problem": name, "captured": lm.LAST_JIT_RUN["captured"],
                      "graphs_cached": lm.LAST_JIT_RUN["graphs_cached"],
                      "entries": len(lm._GRAPHS),
                      "memory_reserved": torch.cuda.memory_reserved(),
                      "memory_allocated": torch.cuda.memory_allocated()})
    lm.clear_graphs()
    emit({"phase": "default_drive_graph_cache", "runs": cache, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(all(c["captured"] and c["graphs_cached"] == c["entries"] == 1
              for c in cache),
          f"default_drive: the graph cache holds more than one problem: {cache}")
    check(cache[3]["memory_reserved"] <= cache[0]["memory_reserved"] * 1.1,
          "default_drive: reserved memory grew from p16 to p16 again: "
          f"{cache[0]['memory_reserved']} -> {cache[3]['memory_reserved']}")
    return launches


def bench_phase(bench_torch, lm, smi) -> dict:
    """``bench``: ``bench_torch.py``'s default run (bench.py's workload:
    p257 df32 cholesky and qrchol to 100 iterations on the jit drive) with
    3 timed runs each, through its ``main``; its lines pass on under the
    phase's name, its last one in ``bench_done``, a ``bench_reference``
    line per workload gives its reads, replays and gate (d), a
    ``bench_control`` line its gate (d3): the observed run's seconds,
    capture, route and endpoint, the iterations checked, the accepts, the
    rejected trials, the mid-range accepts and second growths, what the
    run did not reach, the first rule broken and the largest gap per rule,
    and a ``bench_numerics`` line its gate (e) on the same run: the
    accepted iterations checked and the loose ones (steps under the
    states' rounding, not held to the bound), the largest eta excess (the
    step's backward error less its recovery's allowance), allowance and
    energy gap with its iteration, lambda and rho, the first iteration
    over a bound and the checker's seconds.
    Gate: it exits 0 with ``correct`` true (gates (d), (d3) and (e)
    included) and both p257 fields, no timed run and no observed run
    captured, every workload's control and numerics passed on every
    iteration, every timed run read and replayed once and launched both
    chain kernels. Returns each mode's launches in its first timed run."""
    t_phase = time.perf_counter()
    lines = []

    def out(obj):
        lines.append(obj)
        if "metric" not in obj:
            emit({"phase": "bench", **obj})

    rc = bench_torch.main(["--repeats", "3"], out=out)
    lm.clear_graphs()
    last = lines[-1] if lines else {}
    runs = [x for x in lines if x.get("bench") == "run"]
    for w in (x for x in lines if x.get("bench") == "workload"):
        ref = w["reference"]
        emit({"phase": "bench_reference", "mode": w["mode"], "reads": w["reads"],
              "replays": w["replays"],
              "iterations": w["iterations"], "status": w["status"],
              "within": ref["within"], "error": ref.get("error"),
              "endpoint": ref["endpoint"] and {k: ref["endpoint"][k] for k in (
                  "source", "gaps", "dominates", "within")},
              "prefix": ref["prefix"] and {k: ref["prefix"][k] for k in (
                  "source", "gaps", "within")},
              "nvidia_smi": smi})
        emit({"phase": "bench_control", "mode": w["mode"], **w["control"],
              "nvidia_smi": smi})
        emit({"phase": "bench_numerics", "mode": w["mode"], **w["numerics"],
              "nvidia_smi": smi})
        control = w["control"]
        check(control["ok"] and control["captured"] is False
              and control["same_endpoint"],
              f"bench: {w['mode']}'s gate (d3) failed: captured "
              f"{control['captured']}, same endpoint {control['same_endpoint']}, "
              f"first rule broken {control['broken']}")
        check(w["numerics"]["ok"],
              f"bench: {w['mode']}'s gate (e) failed: over {w['numerics']['over']}, "
              f"error {w['numerics'].get('error')}")
    emit({"phase": "bench_done", "rc": rc, "last_line": last, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(rc == 0 and last.get("correct") is True,
          f"bench: exit code {rc}, last line {last}")
    check(last["metric"] == "lm_iter_per_sec_p257_cholesky"
          and all(f"p257_{m}_iter_per_sec" in last for m in bench_torch.MODES),
          f"bench: last line {last} lacks a p257 field")
    check(len(runs) == 3 * len(bench_torch.MODES)
          and not any(r["captured"] for r in runs),
          "bench: a timed run captured its graph: "
          f"{[(r['mode'], r['captured']) for r in runs]}")
    check(all(r["reads"] == r["replays"] == 1 for r in runs),
          f"bench: a timed run read or replayed more than once: "
          f"{[(r['mode'], r['reads'], r['replays']) for r in runs]}")
    check(all(min(r["launches"][k] for k in lm.cuda_chain.DRIVE_KERNELS["df32"]) > 0
              for r in runs),
          f"bench: a df32 timed run launched no chain kernel: "
          f"{[r['launches'] for r in runs]}")
    return {m: next(r["launches"] for r in runs if r["mode"] == m)
            for m in bench_torch.MODES}


def bench_planted_phase(bench_torch, campaign, lm, problems, smi) -> None:
    """``bench_planted``: gates (d3) and (e) against the faults of
    ``bench_torch.planted_faults`` on bench.py's p257 df32 cholesky
    workload (the jit drive, max_iter 100), and ``step-scaled`` also on
    p16 float64 cholesky (a default float64 workload of
    ``bench_torch.py``; ``energy-scaled`` lives in the df32 chain). The
    step fault's size is the geometry's: ``STEP_FAULT_DF32`` at df32,
    where a smaller one lies under the float32 solve's own error
    (PERF.md), ``STEP_FAULT`` in float64. A run is a warm-up that
    captures a fresh graph (the graph cache cleared before and after, so
    that the capture takes the fault) and ``bench_torch.control_run`` on
    that graph. Gate: the clean runs pass (d3) and (e) on every
    iteration; each (d3) fault that the clean p257 run reaches (its count
    in ``planted_faults``) fails (d3)'s rules; each (e) fault passes (d3)
    and fails (e), at both problems for ``step-scaled``. A fault a clean
    run does not reach is printed as not reached, and does not pass."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    faults = bench_torch.planted_faults()
    cells = {"p257": campaign.drive_config("df32", bench_torch.MAX_ITER),
             "p16": campaign.drive_config("f64", bench_torch.MAX_ITER)}

    step = {"p257": bench_torch.STEP_FAULT_DF32, "p16": bench_torch.STEP_FAULT}

    def run(name, fault):
        lm.clear_graphs()
        try:
            with (bench_torch.planted(bench_torch.planted_faults(step[name])[fault])
                  if fault else contextlib.nullcontext()):
                warm, _ = bench_torch.timed_run(problems[name], "cholesky",
                                                cells[name], dev)
                return (warm, *bench_torch.control_run(
                    problems[name], "cholesky", cells[name], dev, warm))
        finally:
            lm.clear_graphs()

    keys = ("rules", "broken", "iterations", "accepts", "rejected_trials",
            "mid_accepts", "second_growths", "unreached", "gaps", "captured",
            "same_endpoint")

    def line(name, fault, warm, control, numerics, **more):
        emit({"phase": "bench_planted", "problem": name, "fault": fault, **more,
              **{k: warm[k] for k in ("status", "iterations", "fun_evals",
                                      "captured")},
              "control": {k: control[k] for k in keys}, "numerics": numerics,
              "nvidia_smi": smi})

    clean = {}
    for name in cells:
        warm, control, numerics = clean[name] = run(name, None)
        line(name, None, warm, control, numerics)
        check(warm["captured"] and control["ok"] and numerics["ok"],
              f"bench_planted: the clean {name} run captured {warm['captured']}, "
              f"its control broke {control['broken']}, its numerics went over "
              f"{numerics['over']} ({numerics.get('error')})")
    not_reached = []
    for fault, (gate, _, reach) in faults.items():
        for name in (("p257", "p16") if fault == "step-scaled" else ("p257",)):
            reached = clean[name][1 if gate == "control" else 2][reach] > 0
            warm, control, numerics = run(name, fault)
            failed = {"control": not control["rules"], "numerics": not numerics["ok"]}
            line(name, fault, warm, control, numerics, gate=gate, reached=reached,
                 reached_by=reach, failed=failed,
                 size=step[name] if fault == "step-scaled" else None)
            check(warm["captured"], f"bench_planted: {fault}'s run did not capture")
            if not reached:
                not_reached.append([name, fault])
            elif gate == "control":
                check(failed["control"],
                      f"bench_planted: fault {fault} passed gate (d3) on {name}")
            else:
                check(failed["numerics"] and not failed["control"],
                      f"bench_planted: fault {fault} on {name}: failed {failed}, "
                      "where gate (e) alone must fail")
    emit({"phase": "bench_planted_done", "not_reached": not_reached,
          "phase_s": time.perf_counter() - t_phase})


def oracle_prefix_phase(oracle_prefix, loaded, smi) -> None:
    """``oracle_prefix``: float64 cholesky on p126 and p257 to the scipy
    oracle's logged iterations, on both LM drives
    (``oracle_prefix.run_row``; ``loaded``: ``oracle_prefix.load`` of each),
    each row within ``oracle_prefix.CHOLESKY`` and the host drive's path
    equal to the jit drive's."""
    t_phase = time.perf_counter()
    rows = [oracle_prefix.run_row(key, "cholesky", drive, "cuda", loaded[key])
            for key in ("p126", "p257") for drive in oracle_prefix.LM_DRIVES]
    for row in rows:
        emit({"phase": "oracle_prefix", **{k: row[k] for k in (
            "key", "mode", "lm_drive", "iterations", "fun_evals", "energy",
            "jit", "gaps", "budget", "within", "matched")},
            "nvidia_smi": smi})
        check(row["within"], f"oracle_prefix {row['key']} {row['lm_drive']}: "
              f"{row['gaps']} outside {row['budget']}")
    by = {(r["key"], r["lm_drive"]): r for r in rows}
    for key in ("p126", "p257"):
        host, jit = by[(key, "host")], by[(key, "jit")]
        check([p["port_energy"] for p in host["pairs"]]
              == [p["port_energy"] for p in jit["pairs"]]
              and host["matched"]["port"] == jit["matched"]["port"],
              f"oracle_prefix {key}: the host and jit drives part")
    emit({"phase": "oracle_prefix_done", "phase_s": time.perf_counter() - t_phase})


def ellipse_phase(lm, smi) -> None:
    """``ellipse``: ``examples/ellipse_fitting_torch.py`` on the card, held
    to tests/test_examples.py's assertions, and its gap to the same fit on
    the CPU."""
    t_phase = time.perf_counter()
    sys.path.insert(0, str(HERE / "examples"))
    import ellipse_fitting_torch as example

    samples = example.sample_ellipse(center=(1.0, -2.0), axes=(3.0, 1.5), phi=0.6)
    res = example.fit_ellipse(samples, device="cuda")
    cpu = example.fit_ellipse(samples, device="cpu")
    cx, cy, a, b, phi = res.state.tolist()
    emit({"phase": "ellipse", "status": res.status.name,
          "iterations": res.iterations, "fun_evals": res.fun_evals,
          "energy": res.energy, "params": [cx, cy, a, b, phi],
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


def blocked_chol_phase(linalg, smi) -> None:
    """``blocked_chol``: ``ops/linalg.blocked_cholesky`` against float32
    ``torch.linalg.cholesky_ex``, and the two products through
    ``blocked_tril_inv`` against ``torch.cholesky_solve``, on a
    Jacobi-scaled SPD matrix (G G^T / 2n for a normal (n, 2n) G, scaled to
    a unit diagonal) at each of BLOCKED_SIZES: each float32 result's
    relative error against the float64 factor and solve."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
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
            "factor_rel_err": {"cholesky_ex": rel(Lc, L64), "blocked": rel(Lb, L64)},
            "solve_rel_err": {"cholesky_solve": rel(xc, x64),
                              "blocked_tril_inv": rel(xb, x64)},
            "blocked_vs_cholesky_ex": rel(Lb, Lc.double()),
        }
        emit({"phase": "blocked_chol", **line, "dtype": "float32", "block": 384,
              "nvidia_smi": smi})
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
    import bench_torch
    import flatline_campaign
    import oracle_prefix
    from bundleadjustment_benchmarks_tpu_torch import cli
    from bundleadjustment_benchmarks_tpu_torch.io import bal
    from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
    from bundleadjustment_benchmarks_tpu_torch.ops import (cuda_chain, cuda_eigh,
                                                           cuda_graph, jacobian,
                                                           linalg)
    from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
    from bundleadjustment_benchmarks_tpu_torch.utils import balgen, checkpoint

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    # -- build: one nvcc per library, started together ---------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for built in [pool.submit(cuda_chain.load_library),
                      pool.submit(cuda_graph.load_library),
                      pool.submit(cuda_eigh.load_library)]:
            built.result()

    def ptxas(info):
        return [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln or "Compiling entry" in ln]

    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(cuda_chain.NVCC_FLAGS),
          "ptxas": ptxas(cuda_chain.BUILD_INFO),
          "graph_cond_build_s": cuda_graph.BUILD_INFO["seconds"],
          "eigh_build_s": cuda_eigh.BUILD_INFO["seconds"],
          "eigh_ptxas": ptxas(cuda_eigh.BUILD_INFO)})

    # -- kernels against their plain versions --------------------------------
    t_phase = time.perf_counter()
    problems = {name: pm.load_bal_problem(str(path), device=dev)
                for name, path in (("p16", P16), ("p257", P257))}
    if sys.argv[1:] == ["--jit-only"]:  # the device-resident drive's phases
        jit_phases(pm, lm, cuda_chain, cuda_graph, problems, ladybug_standin(balgen),
                   smi)
        eigh_phases(pm, lm, cuda_chain, cuda_eigh, cuda_graph, problems, smi)
        sharded_jit_phases(lm, multihost, problems, smi)
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
        return
    rng = np.random.default_rng(0)
    kern = {"chain_blocks": {"max_abs_err": 0.0, "energy_abs_err": 0.0},
            "chain_energy": {"max_abs_err": 0.0},
            "chain_blocks_f64": {"max_rel_err": 0.0, "energy_rel_err": 0.0},
            "chain_energy_f64": {"max_rel_err": 0.0}}
    cases = []
    for name, prob in problems.items():
        tau2 = prob.tau2
        fast0 = pm.to_fast(prob.state)
        step = (torch.from_numpy(rng.normal(scale=1e-2, size=(prob.n_points, 3))),
                torch.from_numpy(rng.normal(scale=1e-3, size=(prob.n_cameras, 9))))
        step = tuple(s.to(dev) for s in step)
        fast1 = pm.apply_step_fast(fast0, *step)
        f64_states = (("loaded", prob.state), ("perturbed", pm.apply_step(prob.state, *step)))
        for state_name, state in f64_states:
            case = f64_kernels_case(cuda_chain, state, prob)
            case.update(problem=name, state=state_name)
            kern["chain_blocks_f64"]["max_rel_err"] = max(
                kern["chain_blocks_f64"]["max_rel_err"], case["rows_rel_err"])
            kern["chain_blocks_f64"]["energy_rel_err"] = max(
                kern["chain_blocks_f64"]["energy_rel_err"], case["blocks_energy_rel_err"])
            kern["chain_energy_f64"]["max_rel_err"] = max(
                kern["chain_energy_f64"]["max_rel_err"], case["energy_rel_err"])
            if name == "p257" and state_name == "loaded":
                gate = entry_point_ops(f64_entry_points(cuda_chain, state, prob.obs,
                                                        tau2))
                for which in cuda_chain.DRIVE_KERNELS["f64"]:
                    kern[which].update(**gate[which], **cuda_chain.launch_shape(
                        which, prob.n_cameras, prob.n_observations))
            cases.append(case)
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
                "problem": name, "state": state_name, "drive": "df32",
                "K": prob.n_observations,
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
                gate = entry_point_ops(entry_points(cuda_chain, fast, prob.obs, tau2))
                for which in cuda_chain.DRIVE_KERNELS["df32"]:
                    kern[which].update(**gate[which], **cuda_chain.launch_shape(
                        which, prob.n_cameras, prob.n_observations))
            cases.append(case)
    emit({"phase": "kernels", "cases": cases,
          "phase_s": time.perf_counter() - t_phase})
    for c in cases:
        where = f"{c['problem']}/{c['state']}"
        if c["drive"] == "f64":
            check(c["rows_finite"] and c["rows_equal"],
                  f"{where} float64: rows {c['rows_rel_err']} from the plain chain's")
            check(c["blocks_energy_rel_err"] <= F64_ENERGY_RTOL
                  and c["energy_rel_err"] <= F64_ENERGY_RTOL,
                  f"{where} float64: energies {c['blocks_energy_rel_err']}, "
                  f"{c['energy_rel_err']} from the plain chain's")
            check(c["repeats_identical"], f"{where} float64: repeat launches differ")
            continue
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
        check(k["graph_ops_per_call"] == 1
              and k["graph_node_types"] == {"kernel": 2},
              f"{which}: a CUDA graph of one entry-point call holds "
              f"{k['graph_node_types']} with kernels {k['graph_kernels']}, not "
              f"one {which} kernel and the launch counter's")
        check(k["kernels_per_call"] == 1,
              f"{which}: one entry-point call issued {k['kernels_per_call']} "
              f"device operations, not 1, in the profiles that recorded any "
              f"({k['counts']})")

    # -- main path, df32 drive with the kernels, p257 ---------------------------
    t_phase = time.perf_counter()
    p257 = problems["p257"]
    cfg = lm.LMConfig(drive="host", max_iter=20, **DF32)
    check(cfg.use_kernels(dev), "the df32 drive does not select the kernels")
    e0 = cuda_chain.fused_energy(pm.to_fast(p257.state), p257.obs, p257.tau2).item()
    cuda_chain.reset_launches()
    res = lm.minimize(p257, mode="cholesky", config=cfg)
    launches = dict(cuda_chain.LAUNCHES)
    pts = res.state.points
    emit({"phase": "main_df32", "problem": "p257", "iterations": res.iterations,
          "fun_evals": res.fun_evals, "status": res.status.name,
          "initial_energy": e0, "final_energy": res.energy,
          "launches": launches, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(np.isfinite(res.energy) and res.energy < e0,
          f"df32 p257: energy {res.energy} not finite and below {e0}")
    check(tuple(pts.shape) == (p257.n_points, 3) and bool(torch.isfinite(pts).all()),
          "df32 p257: final points not finite of shape (M, 3)")
    for which in cuda_chain.DRIVE_KERNELS["df32"]:
        check(launches[which] > 0, f"{which} was not launched on the main path")
    for which in cuda_chain.DRIVE_KERNELS["df32"]:
        kern[which]["launches_main_df32_host"] = launches[which]

    # The same drive on p16 with the kernels and with the plain chain.
    t_phase = time.perf_counter()
    p16 = problems["p16"]
    runs = {}
    for kernels in (True, False):
        c = lm.LMConfig(drive="host", max_iter=10, kernels=kernels, **DF32)
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
    cfg64 = lm.LMConfig(drive="host", max_iter=10)
    e0 = float(lm._prepare(p16.state, p16, "cholesky")[1])
    cuda_chain.reset_launches()
    res = lm.minimize(p16, mode="cholesky", config=cfg64)
    emit({"phase": "main_f64", "problem": "p16", "iterations": res.iterations,
          "fun_evals": res.fun_evals, "status": res.status.name,
          "initial_energy": e0, "final_energy": res.energy,
          "launches": dict(cuda_chain.LAUNCHES), "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase})
    check(np.isfinite(res.energy) and res.energy < e0,
          f"f64 p16: energy {res.energy} not finite and below {e0}")
    check(all((cuda_chain.LAUNCHES[which] > 0) == (which in cuda_chain.DRIVE_KERNELS["f64"])
              for which in cuda_chain.KERNELS),
          f"f64 p16: launches {cuda_chain.LAUNCHES}, not the float64 pair alone")
    for which in cuda_chain.DRIVE_KERNELS["f64"]:
        kern[which]["launches_main_f64_host"] = cuda_chain.LAUNCHES[which]

    # -- the default LM drive (the main path) and the scipy oracle's prefix -----
    oracle = {"p126": oracle_prefix.load("p126", dev),
              "p257": oracle_prefix.load("p257", dev, problems["p257"])}
    default_launches = default_drive_phase(pm, lm, cuda_chain, problems,
                                           oracle["p126"][0], smi)
    for drive, kernels in cuda_chain.DRIVE_KERNELS.items():
        for which in kernels:
            kern[which]["launches"] = default_launches[drive][which]
    oracle_prefix_phase(oracle_prefix, oracle, smi)
    del oracle
    for mode, launches in bench_phase(bench_torch, lm, smi).items():
        for which in cuda_chain.DRIVE_KERNELS["df32"]:
            kern[which][f"launches_bench_p257_{mode}"] = launches[which]
    bench_planted_phase(bench_torch, flatline_campaign, lm, problems, smi)

    # -- the other solver modes ---------------------------------------------------
    modes_phases(pm, lm, schur, jacobian, cuda_chain, problems, smi)

    # -- the command line ---------------------------------------------------------
    ladybug = ladybug_standin(balgen)
    for which, more in cli_phases(cli, pm, bal, balgen, checkpoint, cuda_chain,
                                  smi, ladybug).items():
        kern[which].update(more)

    # -- the sharded path ---------------------------------------------------------
    for which, more in sharded_phases(pm, lm, sharded, multihost, cli, checkpoint,
                                      cuda_chain, problems, ladybug, smi).items():
        kern[which].update(more)

    # -- the flatline stop, the ellipse example, the blocked Cholesky pair ------
    flatline_phase(flatline_campaign, cuda_chain, smi)
    ellipse_phase(lm, smi)
    blocked_chol_phase(linalg, smi)

    # -- the device-resident drive ------------------------------------------------
    for which, more in jit_phases(pm, lm, cuda_chain, cuda_graph, problems,
                                  ladybug, smi).items():
        kern[which].update(more)

    # -- the eigensolver, pair-less qrkit and the sharded jit drive -------------
    eigh = eigh_phases(pm, lm, cuda_chain, cuda_eigh, cuda_graph, problems, smi)
    for which, more in sharded_jit_phases(lm, multihost, problems, smi).items():
        kern[which].update(more)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    src = "bundleadjustment_benchmarks_tpu_torch/ops/csrc/chain_kernels.cu"
    jnp_chain = "none: the JAX package's float64 chain is XLA-fused jnp"
    replaces = {
        "chain_blocks": "bundleadjustment_benchmarks_tpu/ops/pallas_chain.py:83",
        "chain_energy": "bundleadjustment_benchmarks_tpu/ops/pallas_chain.py:98",
        "chain_blocks_f64": jnp_chain, "chain_energy_f64": jnp_chain,
    }
    # max_abs_err: chain_blocks' rows, chain_energy's energy; the blocks
    # kernel's energy gap is its own field, energy_abs_err. The float64
    # pair's max_rel_err and energy_rel_err: f64_kernels_case's.
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], **k}
        for name, k in kern.items()] + [eigh]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

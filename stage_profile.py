"""Kernels alone on the GPU, against the frozen roofline of
``portbench/core/roofline.py``: the chain kernels, the block Jacobi
eigensolver, the chain entry points' one-operation gate, and where one
float64 prepare's and trial's device time goes.

    python3 stage_profile.py [BAL file] --chain
    python3 stage_profile.py --eigh
    python3 stage_profile.py [BAL file] --one-op N
    python3 stage_profile.py [BAL file] --prepare

``chip_smoke.py`` checks the port and times nothing; where a solve's time
goes is ``portbench/run.py --trace 1``'s to say (PERF.md).

``--chain``: one line per problem at its loaded state (the BAL file given,
or the p257 stand-in and then the generated Ladybug stand-in, whose 1,723
cameras the kernels do not stage). Per kernel its device time alone
(``ms``) and through its entry point (``entry_ms``), the host time to issue
one entry-point call (``host_us``), the plain version's time
(``plain_ms``), the bound (``roofline.kernel_bounds``) and the launch
shape; then its time against the observations it visits, cold and warm
L2, beside an empty kernel's and ``torch.profiler``'s durations, and staged
cameras against the same work unstaged (padded to 2,500), in turns. The
float64 pair (``f64_kernels``) at the loaded float64 state: the same
times, the plain chain it replaces (``residuals_and_jacobian`` +
``compensated_square_sum``; ``projection.energy``) as ``plain_ms``, and its
byte bound (``f64_bounds``, at ``roofline``'s memory rate).

``--eigh``: ``cuda_eigh.jacobi_eigh`` against ``torch.linalg.eigh`` on the
float64 grams that pair-less qrkit factors at p16 and p257 (n = 145 and
2,314), the bound, and each kernel's device time and that of the sweeps
after convergence.

``--one-op N``: each chain entry point profiled N times, one call a
profile, by ``chip_smoke.device_ops_per_call``: the operations counted per
profile and the empty profiles.

``--prepare``: one eager float64 cholesky ``lm._prepare`` and one
``lm._trial`` at the loaded state (p257 unless a BAL file is given), by
``torch.profiler``: each one's device time (the kernels' durations, the
mean of PROFILE_REPS calls) with the plain chain and with the float64
kernels, split into the chain (residuals, Jacobian and energy; the trial's
energy) and the rest (``schur.build_context`` and the initial lambda; the
trial's solve and step), with each part's largest kernels.

Device times are medians of 20 by CUDA events with a cold L2 (``time_ms``);
every line names the card. To compare two checkouts, copy this script and
``chip_smoke.py`` (and ``portbench/core/roofline.py`` where it lacks one)
into the older one, unpacked with ``git archive`` into an ignored
directory, and run both in one call, in turns (A, B, B, A). Without a CUDA
device it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import (cuda_chain, cuda_eigh, jacobian,
                                                       projection)
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
from bundleadjustment_benchmarks_tpu_torch.utils import balgen
from chip_smoke import (P16, P257, device_ops_per_call, entry_points,
                        f64_entry_points, ladybug_standin, nvidia_smi, qrkit_gram)
from portbench.core import roofline

SLEEP = int(2e7)  # ~10 ms: longer than the host's enqueue of one kernel
PLAIN_SLEEP = int(2e8)  # ~100 ms: longer than a plain version's enqueue
REPS = 20
PROFILE_REPS = 5
UNSTAGED_CAMERAS = 2500  # 2,500 x 27 floats exceed a block's shared memory


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


def profiled_us(fn, flush, reps: int = 20) -> dict:
    """Mean duration (µs) of each device kernel that ``fn`` launches, by
    ``torch.profiler``, cold L2 (the flush before each rep)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / e.count
            for e in prof.key_averages() if "chain" in e.key}


def device_kernels(fn, sweeps: Optional[int] = None) -> dict:
    """Device ms and launches of each kernel one call of ``fn`` runs, by
    short name, from ``torch.profiler`` (after a warm-up call). With the
    eigensolver's ``sweeps``, "after_convergence" has the ms and launches
    of its sweeps after the ``sweeps``-th (``sweep_end`` to ``sweep_end``),
    whose launches return at once."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name.replace("(anonymous namespace)::", "").replace("void ", "")
             .split("(")[0].split("<")[0] for e in events]
    split = {}
    for name, e in zip(names, events):
        ms, count = split.get(name, (0.0, 0))
        split[name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    out = {k: {"ms": v[0], "launches": v[1]} for k, v in split.items()}
    ends = [i for i, name in enumerate(names) if name == "sweep_end"]
    if sweeps is not None and len(ends) > sweeps:
        tail = events[ends[sweeps - 1] + 1:ends[-1] + 1]
        out["after_convergence"] = {
            "ms": sum(e.time_range.elapsed_us() for e in tail) / 1e3,
            "launches": len(tail), "sweeps": len(ends) - sweeps}
    return out


def chain_kernels(prob, fast, flush) -> dict:
    """Per chain kernel at ``fast``, ``prob``'s state: ``ms``, ``entry_ms``,
    ``host_us``, ``plain_ms``, the bound and the launch shape (the module
    docstring)."""
    obs, tau2 = prob.obs, prob.tau2
    n, m, k = prob.n_cameras, prob.n_points, prob.n_observations
    bw, fp32 = roofline.card_rates(torch.cuda.get_device_name(0))
    bounds = roofline.kernel_bounds(n, m, k, bw, fp32 / 2)
    ops = cuda_chain.chain_operands(fast, obs)
    entry = entry_points(cuda_chain, fast, obs, tau2)
    plain = {"chain_blocks": lambda: cuda_chain.chain_blocks_plain(fast, obs, tau2),
             "chain_energy": lambda: cuda_chain.fused_energy_plain(fast, obs, tau2)}
    out = {}
    for which in entry:
        out[which] = {
            "ms": time_ms(lambda: cuda_chain.launch(which, ops, tau2), REPS,
                          SLEEP, flush),
            "entry_ms": time_ms(entry[which], REPS, SLEEP, flush),
            "host_us": host_us(entry[which]),
            "plain_ms": time_ms(plain[which], REPS, PLAIN_SLEEP, flush),
            "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
            **cuda_chain.launch_shape(which, n, k)}
    return out


def f64_bounds(n: int, m: int, k: int, bw: float) -> dict:
    """Per float64 chain kernel, its least time by bytes (ms) at the memory
    rate ``bw``: each input read once (the cameras' 15 float64, the float64
    points, the (K, 2) measurements and both int32 indices), each output
    written once (the energy; the blocks kernel's (26, K) float64 rows).
    Their float64 arithmetic, ~200 operations an observation, would take a
    twentieth of that at the card's float64 rate: bytes bound them."""
    inputs = 8 * 15 * n + 8 * 3 * m + 8 * 2 * k + 4 * 2 * k
    return {"chain_blocks_f64": (inputs + 8 * 26 * k + 8) / bw * 1e3,
            "chain_energy_f64": (inputs + 8) / bw * 1e3}


def f64_kernels(prob, flush) -> dict:
    """Per float64 chain kernel at ``prob``'s loaded state: ``ms``,
    ``entry_ms``, ``host_us``, ``plain_ms``, the byte bound and the launch
    shape."""
    state, obs, tau2 = prob.state, prob.obs, prob.tau2
    n, m, k = prob.n_cameras, prob.n_points, prob.n_observations
    bounds = f64_bounds(n, m, k, roofline.card_rates(torch.cuda.get_device_name(0))[0])
    ops = cuda_chain.f64_operands(state, obs)
    entry = f64_entry_points(cuda_chain, state, obs, tau2)
    plain = {"chain_blocks_f64": lambda: projection.compensated_square_sum(
                 jacobian.residuals_and_jacobian(state, obs, tau2).f),
             "chain_energy_f64": lambda: projection.energy(state, obs, tau2)}
    out = {}
    for which in entry:
        out[which] = {
            "ms": time_ms(lambda: cuda_chain.launch_f64(which, ops, tau2), REPS,
                          SLEEP, flush),
            "entry_ms": time_ms(entry[which], REPS, SLEEP, flush),
            "host_us": host_us(entry[which]),
            "plain_ms": time_ms(plain[which], REPS, PLAIN_SLEEP, flush),
            "bound_ms": bounds[which], "bound_by": "bytes",
            **cuda_chain.launch_shape(which, n, k)}
    return out


def chain_line(prob, card: str, name: str) -> None:
    cuda_chain.load_library()
    fast, obs, tau2 = pm.to_fast(prob.state), prob.obs, prob.tau2
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=fast.R.device)
    warm = torch.empty(0, dtype=torch.uint8, device=fast.R.device)
    sweep = []
    for n in (0, 256, 4096, 65536, obs.n_observations):
        cases = {
            "chain_energy": (cuda_chain.chain_operands(fast, obs), n),
            "chain_blocks": (cuda_chain.chain_operands(
                fast, cuda_chain._prefix(obs, n)), None),
        }
        for which, (ops, valid) in cases.items():
            def fn():
                cuda_chain.launch(which, ops, tau2, valid)

            sweep.append({"kernel": which, "n": n,
                          "cold_ms": time_ms(fn, REPS, SLEEP, flush),
                          "warm_ms": time_ms(fn, REPS, SLEEP, warm),
                          "profiled_us": profiled_us(fn, flush)})
    sweep.append({"kernel": "empty (torch.cuda._sleep(0))",
                  "cold_ms": time_ms(lambda: torch.cuda._sleep(0), REPS, SLEEP,
                                     flush)})
    print(json.dumps({
        "card": card, "package": str(Path(cuda_chain.__file__).parents[1]),
        "problem": name, "N": prob.n_cameras, "M": prob.n_points,
        "K": prob.n_observations,
        "kernels": chain_kernels(prob, fast, flush),
        "f64_kernels": f64_kernels(prob, flush),
        "sweep": sweep, "staging": staging(fast, obs, tau2, flush)}),
        flush=True)


def staging(fast, obs, tau2, flush) -> dict:
    """Each kernel on ``fast`` (cameras staged when they fit) and on the same
    cameras padded to UNSTAGED_CAMERAS (the extra ones repeat camera 0 and
    are not observed, so the work is the same but no block stages), timed
    in turns: staged, unstaged, unstaged, staged."""
    pad = max(0, UNSTAGED_CAMERAS - fast.R.shape[0])

    def grow(t):
        return torch.cat([t, t[:1].expand(pad, *t.shape[1:])]).contiguous()

    wide = dataclasses.replace(fast, R=grow(fast.R), T=grow(fast.T),
                               K=grow(fast.K), k1=grow(fast.k1),
                               k2=grow(fast.k2))
    out = {}
    for which in ("chain_blocks", "chain_energy"):
        variants = {}
        for name, state in (("staged", fast), ("unstaged", wide),
                            ("unstaged", wide), ("staged", fast)):
            ops = cuda_chain.chain_operands(state, obs)

            def fn():
                cuda_chain.launch(which, ops, tau2)

            v = variants.setdefault(name, {
                **cuda_chain.launch_shape(which, state.R.shape[0],
                                          obs.n_observations),
                "cold_ms": [], "profiled_us": []})
            v["cold_ms"].append(time_ms(fn, REPS, SLEEP, flush))
            v["profiled_us"].append(profiled_us(fn, flush))
        out[which] = variants
    return out


def eigh_line(S, card: str, name: str, flush) -> None:
    """The eigensolver against ``torch.linalg.eigh`` on the gram ``S``. The
    bound: ~10/3 n^3 flops (LAPACK's tridiagonal route) at the camera
    solve's peak, or S read and V written once at the memory rate, whichever
    is larger."""
    _, _, info, sweeps = cuda_eigh.jacobi_eigh(S)
    kind = torch.cuda.get_device_name(0)
    n = S.shape[0]
    ops_ms = 10 / 3 * n ** 3 / roofline.camera_solve_peak(kind) * 1e3
    bytes_ms = 2 * n * n * 8 / roofline.card_rates(kind)[0] * 1e3
    print(json.dumps({
        "card": card, "package": str(Path(cuda_eigh.__file__).parents[1]),
        "problem": name, "n": n, "dtype": str(S.dtype), "info": int(info),
        "sweeps": int(sweeps),
        "jacobi_ms": time_ms(lambda: cuda_eigh.jacobi_eigh(S), REPS, SLEEP, flush),
        "plain_ms": time_ms(lambda: torch.linalg.eigh(S), REPS, SLEEP, flush),
        "timing": f"median of {REPS}, CUDA events, cold L2",
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "kernels": device_kernels(lambda: cuda_eigh.jacobi_eigh(S), int(sweeps))}),
        flush=True)


def device_split(fn, reps: int = PROFILE_REPS) -> dict:
    """The device time of one call of ``fn`` (ms; the mean of ``reps``
    calls in one profile, ``device_kernels``), its kernel launches and its
    five largest kernels by short name."""
    split = device_kernels(lambda: [fn() for _ in range(reps)])
    top = sorted(split.items(), key=lambda kv: -kv[1]["ms"])[:5]
    return {"ms": sum(v["ms"] for v in split.values()) / reps,
            "launches": sum(v["launches"] for v in split.values()) / reps,
            "top": {k: v["ms"] / reps for k, v in top}}


def prepare_line(prob, card: str, name: str) -> None:
    """``--prepare``: the float64 cholesky prepare and trial at ``prob``'s
    loaded state, plain and with the float64 kernels, and their parts."""
    state, obs, tau2, mode = prob.state, prob.obs, prob.tau2, "cholesky"

    def chain_plain():
        blocks = jacobian.residuals_and_jacobian(state, obs, tau2)
        return blocks, projection.compensated_square_sum(blocks.f)

    def rest(blocks):
        ctx = schur.build_context(blocks, prob, mode)
        return ctx, schur.initial_lambda(ctx, mode).to(torch.float64)

    ctx, lam0 = rest(chain_plain()[0])
    dxp, dxc = schur.solve_damped(ctx, lam0, prob, mode)
    x_test = pm.apply_step(state, dxp, dxc)
    cuda_chain.load_library()
    kernel_blocks = cuda_chain.blocks_energy_f64(state, obs, tau2)[0]
    plain_blocks = chain_plain()[0]
    parts = {
        "prepare_plain": lambda: lm._prepare(state, prob, mode),
        "prepare_kernels": lambda: lm._prepare(state, prob, mode, kernels=True),
        "chain_plain": chain_plain,
        "chain_kernel": lambda: cuda_chain.blocks_energy_f64(state, obs, tau2),
        "rest_plain_blocks": lambda: rest(plain_blocks),
        "rest_planar_blocks": lambda: rest(kernel_blocks),
        "trial_plain": lambda: lm._trial(ctx, state, lam0, prob, mode),
        "trial_kernels": lambda: lm._trial(ctx, state, lam0, prob, mode,
                                           kernels=True),
        "trial_energy_plain": lambda: projection.energy(x_test, obs, tau2),
        "trial_energy_kernel": lambda: cuda_chain.energy_f64(x_test, obs, tau2),
    }
    print(json.dumps({
        "card": card, "package": str(Path(cuda_chain.__file__).parents[1]),
        "problem": name, "N": prob.n_cameras, "M": prob.n_points,
        "K": prob.n_observations, "mode": mode,
        "timing": f"torch.profiler kernel durations, mean of {PROFILE_REPS} calls",
        "parts": {k: device_split(fn) for k, fn in parts.items()}}), flush=True)


def one_op_line(prob, card: str, profiles: int) -> None:
    """``device_ops_per_call`` of each entry point over ``profiles``
    profiles."""
    cuda_chain.load_library()
    out = {}
    entries = {**entry_points(cuda_chain, pm.to_fast(prob.state), prob.obs, prob.tau2),
               **f64_entry_points(cuda_chain, prob.state, prob.obs, prob.tau2)}
    for which, fn in entries.items():
        c = device_ops_per_call(fn, profiles)["counts"]
        out[which] = {"profiles": len(c), "empty_profiles": c.count(0),
                      "ops_per_profile": {str(k): c.count(k) for k in sorted(set(c))}}
    print(json.dumps({"card": card, "K": prob.n_observations, "one_op": out}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", help="BAL file (--chain, --one-op)")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--chain", action="store_true",
                      help="time the chain kernels")
    what.add_argument("--eigh", action="store_true",
                      help="time the eigensolver on the p16 and p257 grams")
    what.add_argument("--one-op", type=int, default=0, metavar="N",
                      help="profile each chain entry point N times")
    what.add_argument("--prepare", action="store_true",
                      help="split a float64 prepare's and trial's device time")
    args = ap.parse_args()
    if args.eigh and args.path:
        ap.error("--eigh takes no BAL file")
    if not torch.cuda.is_available():
        sys.exit("stage_profile: needs a CUDA device")
    card = nvidia_smi()
    if args.prepare:
        path = args.path or str(P257)
        prepare_line(pm.load_bal_problem(path, device="cuda"), card, Path(path).name)
    elif args.one_op:
        one_op_line(pm.load_bal_problem(args.path or str(P257), device="cuda"),
                    card, args.one_op)
    elif args.eigh:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        for path in (P16, P257):
            prob = pm.load_bal_problem(str(path), device="cuda")
            eigh_line(qrkit_gram(pm, lm, cuda_eigh, prob, df32=False), card,
                      path.name, flush)
    elif args.path:
        chain_line(pm.load_bal_problem(args.path, device="cuda"), card,
                   Path(args.path).name)
    else:
        chain_line(pm.load_bal_problem(str(P257), device="cuda"), card, P257.name)
        chain_line(pm.from_bal_dataset(ladybug_standin(balgen), device="cuda"),
                   card, "ladybug-1723-standin")


if __name__ == "__main__":
    main()

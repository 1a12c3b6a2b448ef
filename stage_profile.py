"""Where the LM's time goes on the GPU, for one solver mode and drive.

    python3 stage_profile.py [BAL file] [--mode M] [--drive df32|f64|both]
                             [--lm-drive host|jit|both] [--iters N] [--chain]

Loads the problem (default: the in-repo p257 stand-in) onto CUDA. For the
df32 drive (kernels on) and then the float64 drive (or the one named) it
runs a two-iteration warm-up and traces ``lm.minimize(mode=M,
max_iter=N)`` (default cholesky, 6) with ``torch.profiler``, printing one
JSON line per drive, for the host LM drive, the device-resident one
(``--lm-drive jit``: the warm-up captures its CUDA graph, the traced run
replays it) or both: the card, the traced wall time, the
device-busy share (the sum of kernel times over the wall time), the kernels
and the PyTorch operators with the most device time, and the count of
``torch.linalg.qr`` calls (in cholesky's float32 reduced solve, its
fallbacks from a broken-down Cholesky). The profiler slows the host,
so the busy share it reports is a lower bound of the untraced run's.

``--chain`` instead prints one line on the chain kernels at the problem's
loaded state: per kernel its device time, its entry point's device time, the
host time to issue one call and the device operations one call issues, as
``chip_smoke.py`` measures them (``time_entry_points``); then what limits a
kernel: its time against the observations it visits (the energy kernel by
``valid_count``, the blocks kernel by a prefix of the observations), with a
cold and a warm L2, the CUDA-event time of an empty kernel, and each
kernel's own duration as ``torch.profiler`` records it; and each kernel with
its cameras staged in shared memory against the same work unstaged (the
cameras padded to 2,500, which do not fit), in turns. To compare two
checkouts, copy this script and ``chip_smoke.py`` into the older one
(unpacked with ``git archive`` into an ignored directory), run both in one
call, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
from chip_smoke import P257 as DEFAULT, nvidia_smi, time_entry_points, time_ms

SLEEP = int(2e7)  # ~10 ms: longer than the host's enqueue
UNSTAGED_CAMERAS = 2500  # 2,500 x 27 floats exceed a block's shared memory


def _top(events, n=15):
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    return [{"name": e.key[:90], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in top[:n]]


def profile_drives(prob, card: str, path: str, mode: str, drive: str,
                   iters: int, lm_drive: str = "host") -> None:
    for name, lm_name in [(d, ld) for d in ("df32", "f64")
                          for ld in ("host", "jit")]:
        if drive not in ("both", name) or lm_drive not in ("both", lm_name):
            continue
        kw = dict(matmul_dtype="float32", geometry="df32") if name == "df32" else {}

        def run(max_iter):
            return lm.minimize(prob, mode=mode, config=lm.LMConfig(
                max_iter=max_iter, drive=lm_name, **kw))

        run(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run(iters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        ops = [e for e in events if e.device_type == DeviceType.CPU
               and e.key.startswith("aten::") and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        qr = sum(e.count for e in events if e.key == "aten::linalg_qr")
        print(json.dumps({
            "card": card, "problem": Path(path).name, "mode": mode,
            "drive": name, "lm_drive": lm_name,
            "jit": dict(lm.LAST_JIT_RUN) if lm_name == "jit" else None,
            "K": prob.n_observations, "N": prob.n_cameras, "M": prob.n_points,
            "iterations": res.iterations, "fun_evals": res.fun_evals,
            "energy": res.energy, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "linalg_qr_calls": qr, "top_kernels": _top(kernels),
            "top_ops": _top(ops),
        }), flush=True)


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


def chain_line(prob, card: str, path: str) -> None:
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
                          "cold_ms": time_ms(fn, 20, SLEEP, flush),
                          "warm_ms": time_ms(fn, 20, SLEEP, warm),
                          "profiled_us": profiled_us(fn, flush)})
    sweep.append({"kernel": "empty (torch.cuda._sleep(0))",
                  "cold_ms": time_ms(lambda: torch.cuda._sleep(0), 20, SLEEP,
                                     flush)})
    print(json.dumps({
        "card": card, "package": str(Path(cuda_chain.__file__).parents[1]),
        "problem": Path(path).name, "K": prob.n_observations,
        **time_entry_points(cuda_chain, fast, obs, tau2, flush),
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
            v["cold_ms"].append(time_ms(fn, 20, SLEEP, flush))
            v["profiled_us"].append(profiled_us(fn, flush))
        out[which] = variants
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=str(DEFAULT), help="BAL file")
    ap.add_argument("--mode", default="cholesky", choices=schur.MODES,
                    help="solver mode to trace (default cholesky)")
    ap.add_argument("--drive", default="both", choices=("df32", "f64", "both"),
                    help="drive(s) to trace (default both)")
    ap.add_argument("--lm-drive", default="host",
                    choices=("host", "jit", "both"),
                    help="LM drive(s) to trace: the host loop, the "
                    "device-resident graph, or both (default host)")
    ap.add_argument("--iters", type=int, default=6,
                    help="LM iterations traced (default 6)")
    ap.add_argument("--chain", action="store_true",
                    help="time the chain kernels instead of tracing the LM")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stage_profile: needs a CUDA device")
    card = nvidia_smi()
    prob = pm.load_bal_problem(args.path, device="cuda")
    if args.chain:
        chain_line(prob, card, args.path)
    else:
        profile_drives(prob, card, args.path, args.mode, args.drive,
                       args.iters, args.lm_drive)


if __name__ == "__main__":
    main()

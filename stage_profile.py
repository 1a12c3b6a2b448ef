"""The chain kernels on the GPU: their times and what limits them, and
their one-operation gate.

    python3 stage_profile.py [BAL file] --chain
    python3 stage_profile.py [BAL file] --one-op N

Loads the problem (default: the in-repo p257 stand-in) onto CUDA.
Where the LM's time goes is the benchmark's to say: ``python3
portbench/run.py --workload <cell> --seed <n> --seconds 30 --trace 1``
reads it from a ``torch.profiler`` trace of whole solves, by the port's
in-graph spans (PERF.md).

``--chain`` prints one line on the chain kernels at the problem's
loaded state: per kernel its device time, its entry point's device time, the
host time to issue one call and the device operations one call issues, as
``chip_smoke.py`` measures them (``time_entry_points``); then what limits a
kernel: its time against the observations it visits (the energy kernel by
``valid_count``, the blocks kernel by a prefix of the observations), with a
cold and a warm L2, the CUDA-event time of an empty kernel, and each
kernel's own duration as ``torch.profiler`` records it; and each kernel with
its cameras staged in shared memory against the same work unstaged (the
cameras padded to 2,500, which do not fit), in turns.

``--one-op N`` profiles each chain entry point N times, one call a
profile, with ``chip_smoke.py``'s one-operation gate
(``device_ops_per_call``), and prints the device operations counted per
profile and the empty profiles. To compare two
checkouts, copy this script and ``chip_smoke.py`` into the older one
(unpacked with ``git archive`` into an ignored directory), run both in one
call, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain
from chip_smoke import (P257 as DEFAULT, device_ops_per_call, nvidia_smi,
                        time_entry_points, time_ms)

SLEEP = int(2e7)  # ~10 ms: longer than the host's enqueue
UNSTAGED_CAMERAS = 2500  # 2,500 x 27 floats exceed a block's shared memory


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


def one_op_line(prob, card: str, profiles: int) -> None:
    """``device_ops_per_call`` of each entry point over ``profiles``
    profiles."""
    cuda_chain.load_library()
    fast, obs, tau2 = pm.to_fast(prob.state), prob.obs, prob.tau2
    entry = {"chain_blocks": lambda: cuda_chain.fused_blocks_energy(fast, obs, tau2),
             "chain_energy": lambda: cuda_chain.fused_energy(fast, obs, tau2)}
    out = {}
    for which, fn in entry.items():
        c = device_ops_per_call(fn, profiles)["counts"]
        out[which] = {"profiles": len(c), "empty_profiles": c.count(0),
                      "ops_per_profile": {str(k): c.count(k) for k in sorted(set(c))}}
    print(json.dumps({"card": card, "K": prob.n_observations, "one_op": out}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=str(DEFAULT), help="BAL file")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--chain", action="store_true",
                      help="time the chain kernels")
    what.add_argument("--one-op", type=int, default=0, metavar="N",
                      help="profile each chain entry point N times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("stage_profile: needs a CUDA device")
    card = nvidia_smi()
    prob = pm.load_bal_problem(args.path, device="cuda")
    if args.one_op:
        one_op_line(prob, card, args.one_op)
    else:
        chain_line(prob, card, args.path)


if __name__ == "__main__":
    main()

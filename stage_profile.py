"""Where the LM's time goes on the GPU, cholesky mode, for both drives.

    python3 stage_profile.py [BAL file]

Loads the problem (default: the in-repo p257 stand-in) onto CUDA. For the
df32 drive (kernels on) and then the float64 drive it runs a two-iteration
warm-up and traces ``lm.minimize(max_iter=6)`` with ``torch.profiler``,
printing one JSON line per drive: the card, the traced wall time, the
device-busy share (the sum of kernel times over the wall time), the kernels
and the PyTorch operators with the most device time, and how often the
reduced solve fell back from Cholesky to QR. The profiler slows the host,
so the busy share it reports is a lower bound of the untraced run's.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.solvers import lm
from chip_smoke import P257 as DEFAULT, nvidia_smi


def _top(events, n=15):
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    return [{"name": e.key[:90], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in top[:n]]


def main(path: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("stage_profile: needs a CUDA device")
    card = nvidia_smi()
    prob = pm.load_bal_problem(path, device="cuda")

    drives = {"df32": dict(matmul_dtype="float32", geometry="df32"),
              "f64": {}}
    for drive, kw in drives.items():
        def run(max_iter):
            return lm.minimize(prob, mode="cholesky",
                               config=lm.LMConfig(max_iter=max_iter, **kw))

        run(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run(6)
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
            "card": card, "problem": Path(path).name, "drive": drive,
            "K": prob.n_observations, "N": prob.n_cameras, "M": prob.n_points,
            "iterations": res.iterations, "fun_evals": res.fun_evals,
            "energy": res.energy, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "qr_fallbacks": qr, "top_kernels": _top(kernels),
            "top_ops": _top(ops),
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else str(DEFAULT))

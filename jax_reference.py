"""The JAX package's float64 LM prefix on the generated Ladybug stand-in: the
reference that ``bench_torch.py --problem ladybug`` holds the port's own
float64 prefix to, where no scipy-oracle log exists.

    JAX_PLATFORMS=cpu python3 jax_reference.py [--iters 2]
        [--json torch_results/jax_prefix_ladybug_cpu.json]

The stand-in is ``flatline_campaign.py``'s (BAL's Ladybug
problem-1723-156502 shape, seed 1723), generated by the JAX package's own
``utils/balgen`` (array for array the port's generator). The JAX package
runs ``mode`` (cholesky) in float64 on its host LM drive for ``--iters``
iterations; its metrics JSONL gives the energy after each accepted
iteration (an Accepted row's ``f`` is the energy before its step, so the
energy after iteration k is iteration k + 1's and, for the last, the
result's) and the lambda after it (the Accepted row's ``lambda``, its
damping update applied). The reference's statistics (Utils.h:15-68, focal 1.0, inlier
threshold 0.5 px) are computed by the JAX package on its final state.

The artifact (``--json``, relative to this file's directory) holds the
problem's shape, the energies and lambdas (``trace``), the statistics at the last
iteration (``matched``), JAX's version, the machine and the seconds the run
took. It runs on whatever platform JAX is given (the CPU above). Nothing
of the PyTorch port imports this script.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import tempfile
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import flatline_campaign as campaign  # noqa: E402
from bundleadjustment_benchmarks_tpu.models import problem as jpm  # noqa: E402
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm  # noqa: E402
from bundleadjustment_benchmarks_tpu.utils import balgen as jbalgen  # noqa: E402
from bundleadjustment_benchmarks_tpu.utils import stats as jstats  # noqa: E402

ARTIFACT = "torch_results/jax_prefix_ladybug_cpu.json"
ITERS = 2


def ladybug_dataset():
    """The Ladybug stand-in as the JAX package generates it."""
    n, m, k = campaign.LADYBUG
    return jbalgen.generate_bal_like(n, m, seed=n, mean_degree=k / m)


def statistics(state, obs) -> dict:
    """The reference's statistics of ``state``, computed by the JAX
    package, under ``flatline_campaign.post_statistics``' keys."""
    st = jstats.error_statistics(state, obs, campaign.FOCAL, campaign.TAU)
    return {
        "mean_reprojection_error": float(st.mean_reprojection_error),
        "inlier_mean_reprojection_error": float(st.inlier_mean_reprojection_error),
        "n_inliers": int(st.n_inliers),
        "n_observations": int(st.n_observations),
        "true_objective": float(jstats.true_objective(state, obs, campaign.FOCAL,
                                                      campaign.TAU)),
    }


def jax_prefix(ds, mode: str = "cholesky", iters: int = ITERS) -> dict:
    """The JAX package's float64 ``mode`` on its host drive for ``iters``
    iterations from the dataset's state: {mode, iters, status, iterations,
    fun_evals, energy, trace: [{iter, energy, lam}], matched: {iter, stats}}.
    Raises where the run stopped before its ``iters``-th iteration."""
    problem = jpm.from_bal_dataset(ds, dtype=jnp.float64)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        res = jlm.minimize(problem, mode, jlm.LMConfig(drive="host", max_iter=iters),
                           metrics_path=path)
        with open(path) as f:
            records = [json.loads(line) for line in f]
    if res.status != jlm.LMStatus.MaxItersReached:
        raise RuntimeError(f"JAX {mode} stopped at iteration {res.iterations} "
                           f"({jlm.STATUS_STRINGS[res.status]}) before {iters}")
    accepted = {r["iter"]: r for r in records if r["status"] == "Accepted"}
    energies = [accepted[k + 1]["f"] for k in range(1, iters)] + [float(res.energy)]
    return {"mode": mode, "iters": iters,
            "status": jlm.STATUS_STRINGS[res.status],
            "iterations": int(res.iterations), "fun_evals": int(res.fun_evals),
            "energy": float(res.energy),
            "trace": [{"iter": k, "energy": e, "lam": accepted[k]["lambda"]}
                      for k, e in enumerate(energies, 1)],
            "matched": {"iter": iters, "stats": statistics(res.state, problem.obs)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--json", default=ARTIFACT,
                    help="the artifact, relative to this file's directory")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    ds = ladybug_dataset()
    ref = jax_prefix(ds, "cholesky", args.iters)
    out = {"problem": campaign.LADYBUG_NAME, "seed": campaign.LADYBUG[0],
           "n_cameras": int(ds.n_cameras), "n_points": int(ds.n_points),
           "n_observations": int(len(ds.cam_idx)), "geometry": "f64",
           "lm_drive": "host", **ref,
           "jax": jax.__version__, "backend": jax.default_backend(),
           "machine": f"{platform.machine()}, {os.cpu_count()} CPUs, "
                      f"{platform.processor() or platform.platform()}",
           "seconds": time.perf_counter() - t0}
    path = os.path.join(HERE, args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "trace"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

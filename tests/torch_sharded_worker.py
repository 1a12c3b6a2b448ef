"""What the ranks of tests/test_torch_sharded.py and test_torch_multihost.py
run. ``multihost.run_ranks`` spawns them; they import this module by name
and nothing of JAX (tests/conftest.py, which imports it, does not load in a
spawned rank). Inputs and results are numpy arrays and Python scalars."""

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded
from bundleadjustment_benchmarks_tpu_torch.solvers import lm
from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint

MODES = ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")
DF32 = dict(matmul_dtype="float32", geometry="df32")


def _np(t):
    return t.detach().cpu().numpy().copy()


def _full_state(sp, x, df32: bool) -> dict:
    """Cameras and all points of a loop state (a collective)."""
    s = pm.from_fast(x, dtype=torch.float64) if df32 else x
    return {"T": _np(s.T), "R": _np(s.R),
            "points": _np(sharded.unshard_points(sp, s.points))}


def _step(sp, mode, kw, lam):
    """One sharded prepare and one trial at ``lam``."""
    prepare, trial = sharded.make_sharded_kernels(sp, mode, lm.LMConfig(**kw))
    df32 = bool(kw)
    x0 = pm.to_fast(sp.problem.state) if df32 else sp.problem.state
    ctx, energy, lam0 = prepare(x0)
    x, e, rho = trial(ctx, x0, lam)
    return {"energy": float(energy), "lam0": float(lam0), "U": _np(ctx.U),
            "g_cams": _np(ctx.g_cams), "e": float(e), "rho": float(rho),
            **_full_state(sp, x, df32)}


def _result(res) -> dict:
    return {"iterations": res.iterations, "fun_evals": res.fun_evals,
            "status": int(res.status), "energy": res.energy, "lam": res.lam,
            "T": _np(res.state.T), "points": _np(res.state.points),
            "dtype": str(res.state.points.dtype)}


def run_case(rank: int, device, case: dict, problems: dict):
    """One case of the list ``cases`` runs; see there."""
    kind = case["kind"]
    n = dist.get_world_size()
    sp = sharded.shard_problem(problems[case["problem"]], n, rank, device=device)
    if kind == "step":
        return _step(sp, case["mode"], case.get("config", {}), case["lam"])
    if kind == "minimize":
        cfg = lm.LMConfig(**case["config"])
        lm.LAST_JIT_RUN.clear()
        if case.get("trace"):
            # minimize_sharded's run with a trace, which lm.minimize takes.
            reduce = sharded.AllReduce(sp)
            res = lm.minimize(sp.problem, case["mode"], cfg, device=device,
                              reduce=reduce, trace=[])
            res = res._replace(state=dataclasses.replace(
                res.state, points=reduce.points(res.state.points)))
        else:
            res = sharded.minimize_sharded(sp, case["mode"], cfg)
        out = _result(res)
        out["jit"] = dict(lm.LAST_JIT_RUN)
        return out
    if kind == "checkpoint":
        ck, mt = case["checkpoint"], case["metrics"]
        lm.LAST_JIT_RUN.clear()
        res = sharded.minimize_sharded(
            sp, "cholesky", lm.LMConfig(max_iter=case["max_iter"],
                                        drive=case.get("drive", "host")),
            checkpoint_path=ck, checkpoint_every=case["every"], metrics_path=mt)
        return {**_result(res), "jit": dict(lm.LAST_JIT_RUN)}
    if kind == "jit_counts":
        # The jit drive's collective totals against the Python count of
        # the collectives the (eager, CPU) loop issued.
        reduce = sharded.AllReduce(sp)
        res = lm.minimize(sp.problem, case["mode"],
                          lm.LMConfig(drive="jit", **case["config"]),
                          device=device, reduce=reduce)
        # (The result's points are this rank's slice: not returned.)
        return {"fun_evals": res.fun_evals, "jit": dict(lm.LAST_JIT_RUN),
                "calls": reduce.calls, "bytes": reduce.bytes}
    if kind == "jit_first_trial":
        # One slot of the sharded device loop: a prepare and one trial at lam.
        cfg = lm.LMConfig(drive="jit", **case.get("config", {}))
        reduce = sharded.AllReduce(sp)
        prepare, trial, to_loop, _ = lm.step_functions(
            sp.problem, case["mode"], cfg, device, reduce)
        x0 = to_loop(sp.problem.state)
        loop = lm.DeviceLoop(x0, prepare, trial, cfg, device, reduce)
        return {"e": loop.first_trial(x0, case["lam"])}
    if kind == "resume":
        state, meta = checkpoint.load_checkpoint(case["checkpoint"], device="cpu")
        again = sharded.shard_problem(
            dataclasses.replace(problems[case["problem"]], state=state), n, rank,
            device=device)
        return _result(sharded.minimize_sharded(
            again, "cholesky", lm.LMConfig(drive="host", max_iter=case["max_iter"]),
            resume=meta))
    if kind == "refine":
        try:
            sharded.minimize_sharded(sp, "cholesky", lm.LMConfig(max_iter=2,
                                                                 refine_steps=1))
        except ValueError as e:
            return str(e)
        return None
    raise ValueError(f"unknown case kind {kind!r}")


def cases(rank: int, device, case_list, problem_arrays) -> dict:
    """Every case of ``case_list`` on this rank: {name: result}. A case is
    a dict with ``name``, ``kind`` ("step": one prepare and one trial at
    ``lam``; "minimize" (with ``lm.LAST_JIT_RUN``; with ``trace`` true
    through ``lm.minimize`` with a trace); "checkpoint": a run
    that writes checkpoints and metrics; "resume": a run from a
    checkpoint; "refine"; "jit_counts": a jit-drive run's collective
    totals beside the reduce's own count; "jit_first_trial": one slot of
    the sharded device loop at ``lam``), ``problem`` (a
    key of ``problem_arrays``, dicts of ``convert.problem_to_numpy``) and
    the kind's fields. ``_rank`` and ``_backend`` tell who computed it."""
    problems = {k: convert.problem_from_numpy(v, device="cpu")
                for k, v in problem_arrays.items()}
    out = {c["name"]: run_case(rank, device, c, problems) for c in case_list}
    out["_rank"] = rank
    out["_backend"] = dist.get_backend()
    return out


def group_all_reduce(rank: int, device) -> dict:
    """An all-reduce of rank + 1 and the multihost view of the group."""
    t = torch.tensor([float(rank + 1)], device=device)
    dist.all_reduce(t)
    mesh = multihost.global_mesh(device=device)
    return {"sum": float(t.item()), "coordinator": multihost.is_coordinator(),
            "rank": mesh.rank, "size": mesh.size, "pid": os.getpid()}


def num_threads(rank: int, device) -> int:
    """The rank's intra-op thread count."""
    return torch.get_num_threads()


def fail_on_rank_1(rank: int, device) -> None:
    if rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    dist.barrier()


def hang_on_rank_1(rank: int, device) -> None:
    """Rank 1 never joins the all-reduce rank 0 waits in."""
    if rank == 1:
        import time
        time.sleep(3600)
    t = torch.zeros(1)
    dist.all_reduce(t)


def all_reduce_for(rank: int, device, rounds: int, pause: float) -> dict:
    """``rounds`` all-reduces, ``pause`` seconds apart: a run that lasts far
    longer than any one collective."""
    import time
    t0 = time.monotonic()
    t = torch.ones(1)
    for _ in range(rounds):
        dist.all_reduce(t)
        time.sleep(pause)
    return {"value": float(t.item()), "seconds": time.monotonic() - t0}


def env_worker_main() -> None:
    """A torchrun-style rank (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT in
    the environment): ``multihost.initialize(backend="gloo")``, the rest
    from the environment, one all-reduce, one JSON line."""
    assert multihost.initialize(backend="gloo", timeout=60.0)
    out = group_all_reduce(dist.get_rank(), torch.device("cpu"))
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    env_worker_main()

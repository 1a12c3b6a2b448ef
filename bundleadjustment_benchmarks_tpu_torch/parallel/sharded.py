"""Distributed bundle adjustment: points and their observations sharded over
the ranks of a ``torch.distributed`` group, cameras replicated.

Counterpart of the JAX package's ``parallel/sharded.py`` (``shard_map``
over a device mesh). The reference has no distributed code; its data
parallelism (M independent point blocks, K independent observation
Jacobians) is what shards here:

  * points split into D contiguous chunks balanced by observation count,
    the JAX package's boundaries, so each rank's observations are one
    contiguous slice (observations are sorted by point) and every point's
    observations live on one rank;
  * each rank holds a ``BAProblem`` of exactly its slice, with its own
    point, camera, pair and banded tables and no padding: torch.distributed
    needs equal shapes only in the collectives, and every collective here
    is on a replicated shape. Cameras (9N parameters) are replicated;
  * the LM loop is ``lm.minimize``'s, with ``AllReduce`` as its
    ``schur.Reduce``. Per iteration it all-reduces the energy, U and g_cams
    (one (N, 10, 10) camera gram), the max of diag(V) (``ReduceOp.MAX``)
    and, for qrkit, the lambda-free reduced system's partial sums; per
    trial the reduced camera system's partial sums (spqr's and pair-less
    qrkit's (9N+1)^2 camera gram instead), the trial energy and rho's point
    terms. Every rank then solves the replicated camera system itself, and
    the point back-substitution is local. All ranks read the same reduced
    bytes, so they take the same decisions and hold the same cameras.

On the df32 drive each rank launches both chain kernels on its own slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from bundleadjustment_benchmarks_tpu_torch import resolve_device
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain
from bundleadjustment_benchmarks_tpu_torch.parallel import multihost
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur

@dataclasses.dataclass
class ShardedProblem:
    """One rank's shard: ``problem`` holds its points (global indices
    ``pt_starts[rank]`` on) and their observations with rank-local indices,
    and every camera."""

    problem: pm.BAProblem
    rank: int
    n_shards: int
    #: Global index of each shard's first point (shards are balanced by
    #: observation count, so the chunks are uneven).
    pt_starts: tuple
    n_points_global: int

    @property
    def device(self) -> torch.device:
        return self.problem.state.T.device

    @property
    def pt_range(self) -> tuple:
        """(first, last + 1) global point of this shard."""
        ends = self.pt_starts[1:] + (self.n_points_global,)
        return self.pt_starts[self.rank], ends[self.rank]


def shard_bounds(pt_idx: np.ndarray, n_points: int, n_shards: int):
    """(pt_bounds, obs_bounds), each n_shards + 1 long: the JAX package's
    split of point-sorted observations into contiguous point chunks of
    about K / D observations each."""
    k = pt_idx.shape[0]
    cum = np.cumsum(np.bincount(pt_idx, minlength=n_points))
    targets = (np.arange(1, n_shards) * k) // n_shards
    pt_bounds = np.concatenate(
        [[0], np.searchsorted(cum, targets, side="left") + 1, [n_points]])
    obs_bounds = np.append(np.searchsorted(pt_idx, pt_bounds[:-1]), k)
    return pt_bounds.astype(np.int64), obs_bounds.astype(np.int64)


def _take(t: torch.Tensor, index) -> torch.Tensor:
    """An owned contiguous CPU copy of ``t[index]``."""
    return t.detach().cpu()[index].contiguous().clone()


def shard_problem(problem: pm.BAProblem, n_shards: int, rank: int,
                  device=None) -> ShardedProblem:
    """Shard ``rank`` of ``problem`` split ``n_shards`` ways, on ``device``
    (CUDA unless the caller names one). Raises ValueError where a shard
    would hold no observation."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} is not one of {n_shards} shards")
    device = resolve_device(device)
    pt_idx = problem.obs.pt_idx.cpu().numpy()
    cam_idx = problem.obs.cam_idx.cpu().numpy()
    m, n, k = problem.n_points, problem.n_cameras, pt_idx.shape[0]
    pt_b, obs_b = shard_bounds(pt_idx, m, n_shards)
    empty = np.nonzero((np.diff(pt_b) == 0) | (np.diff(obs_b) == 0))[0]
    if empty.size:
        raise ValueError(f"{n_shards} shards of {m} points and {k} observations "
                         f"leave shard {empty[0]} without observations")
    plo, phi = int(pt_b[rank]), int(pt_b[rank + 1])
    lo, hi = int(obs_b[rank]), int(obs_b[rank + 1])
    pt_loc = (pt_idx[lo:hi] - plo).astype(np.int32)
    cam_loc = cam_idx[lo:hi].astype(np.int32)

    st, obs = problem.state, problem.obs
    everything = slice(None)
    state = pm.BAState(K=_take(st.K, everything), R=_take(st.R, everything),
                       T=_take(st.T, everything), k1=_take(st.k1, everything),
                       k2=_take(st.k2, everything),
                       points=_take(st.points, slice(plo, phi)))
    local_obs = pm.BAObservations(
        cam_idx=torch.from_numpy(cam_loc), pt_idx=torch.from_numpy(pt_loc),
        measurements=_take(obs.measurements, slice(lo, hi)),
        weights=_take(obs.weights, slice(lo, hi)),
        measurements_pl=None if obs.measurements_pl is None
        else _take(obs.measurements_pl, (everything, slice(lo, hi))),
    )
    tables = pm.load_time_tables(cam_loc, pt_loc, n, phi - plo)
    if tables["pairs"] is None and (np.bincount(pt_idx, minlength=m) >= 2).any():
        # Other shards have pair tables: take their path with none here.
        tables["pairs"] = pm.empty_pair_tables(n, hi - lo, phi - plo)
    local = pm.BAProblem(state=state, obs=local_obs,
                         inlier_threshold=problem.inlier_threshold,
                         avg_focal_length=problem.avg_focal_length, **tables)
    return ShardedProblem(
        problem=local.to(device), rank=rank, n_shards=n_shards,
        pt_starts=tuple(int(x) for x in pt_b[:-1]), n_points_global=m)


class AllReduce(schur.Reduce):
    """``schur.Reduce`` over the process group whose rank r holds shard r.
    Counts its collectives and the bytes they reduce (``calls``,
    ``bytes``)."""

    sharded = True

    def __init__(self, sp: ShardedProblem):
        if not dist.is_initialized():
            raise RuntimeError("the sharded path needs a process group "
                               "(multihost.initialize or multihost.run_ranks)")
        size, rank = dist.get_world_size(), dist.get_rank()
        if (rank, size) != (sp.rank, sp.n_shards):
            raise ValueError(f"the problem is shard {sp.rank} of {sp.n_shards}, "
                             f"this process is rank {rank} of {size}")
        self.rank = sp.rank
        self.pt_range, self.n_points = sp.pt_range, sp.n_points_global
        self.calls = self.bytes = 0

    def _all_reduce(self, t, op) -> None:
        dist.all_reduce(t, op=op)
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def sum(self, *ts):
        ts = tuple(t.contiguous() for t in ts)
        for t in ts:
            self._all_reduce(t, dist.ReduceOp.SUM)
        return ts

    def max(self, t):
        t = t.clone()
        self._all_reduce(t, dist.ReduceOp.MAX)
        return t

    def points(self, pts):
        """All (M, 3) points from this rank's: each rank places its chunk
        in zeros and the sum adds the disjoint chunks."""
        lo, hi = self.pt_range
        full = pts.new_zeros((self.n_points,) + tuple(pts.shape[1:]))
        full[lo:hi] = pts
        self._all_reduce(full, dist.ReduceOp.SUM)
        return full


def make_sharded_kernels(sp: ShardedProblem, mode: str = "cholesky",
                         config: Optional[lm.LMConfig] = None):
    """``lm.lm_loop``'s (prepare, trial) on this rank's shard for
    ``config``'s drive; the loop state is ``sp.problem.state`` (through
    ``models.problem.to_fast`` on the df32 drive). Every rank of the group
    must call them in step."""
    prepare, trial, _, _ = lm.step_functions(
        sp.problem, mode, config or lm.LMConfig(), sp.device, AllReduce(sp))
    return prepare, trial


def unshard_points(sp: ShardedProblem, points: torch.Tensor) -> torch.Tensor:
    """The (M, 3) points of all ranks from this rank's (a collective)."""
    return AllReduce(sp).points(points)


def minimize_sharded(sp: ShardedProblem, mode: str = "cholesky",
                     config: Optional[lm.LMConfig] = None, resume=None,
                     checkpoint_path: Optional[str] = None,
                     checkpoint_every: int = 0,
                     metrics_path: Optional[str] = None,
                     metrics_phase: Optional[str] = None) -> lm.LMResult:
    """LM on the sharded problem: ``lm.minimize``'s control flow, the
    two-phase polish included, on the device the shard lives on
    (``shard_problem``'s ``device``). Every rank of the process group calls
    it and every rank returns the same result, with all M points in its
    state.

    Rank 0 alone prints the table and writes the metrics and the
    checkpoints; a checkpoint holds the full state, so it resumes at any
    shard count or on one device (shard the problem with the checkpoint's
    state and pass its meta as ``resume``). ``config.refine_steps`` raises:
    the JAX package's sharded solve has no refinement either. So does
    ``config.drive == "jit"``: the device-resident drive would have to
    capture the per-trial all-reduces into its CUDA graph, which it does
    not yet."""
    if config is not None and config.drive == "jit":
        raise ValueError(
            "minimize_sharded: drive='jit' has no sharded form yet (NCCL "
            "collectives captured into the CUDA graph); use drive='host'")
    reduce = AllReduce(sp)
    res = lm.minimize(sp.problem, mode, config, device=sp.device, resume=resume,
                      checkpoint_path=checkpoint_path,
                      checkpoint_every=checkpoint_every,
                      metrics_path=metrics_path, metrics_phase=metrics_phase,
                      reduce=reduce)
    return res._replace(state=dataclasses.replace(
        res.state, points=reduce.points(res.state.points)))


#: The dry run's configurations: (name, mode, LMConfig keywords).
DRYRUN_CONFIGS = (
    ("f64_cholesky", "cholesky", {}),
    ("df32_cholesky", "cholesky", dict(matmul_dtype="float32", geometry="df32")),
    ("f64_qrkit", "qrkit", {}),
    ("f64_spqr", "spqr", {}),
)


def _dryrun_rank(rank: int, device, n_shards: int) -> dict:
    from bundleadjustment_benchmarks_tpu_torch.utils.synthetic import (
        make_synthetic_problem)

    problem = make_synthetic_problem(n_cameras=4, n_points=4 * n_shards,
                                     obs_per_point=3, seed=0, device="cpu")
    sp = shard_problem(problem, n_shards, rank, device=device)
    before = dict(cuda_chain.LAUNCHES)
    out = {}
    for name, mode, kw in DRYRUN_CONFIGS:
        prepare, trial = make_sharded_kernels(sp, mode, lm.LMConfig(**kw))
        x0 = pm.to_fast(sp.problem.state) if kw else sp.problem.state
        ctx, energy, lam0 = prepare(x0)
        _, e_test, rho_scale = trial(ctx, x0, float(lam0))
        out[name] = [float(energy), float(e_test), float(rho_scale)]
        if not all(map(math.isfinite, out[name])):
            raise FloatingPointError(f"dry run {name}: energy, trial energy, "
                                     f"rho denominator {out[name]}")
    out["launches"] = {k: v - before[k] for k, v in cuda_chain.LAUNCHES.items()}
    return out


def dryrun_multichip(n_devices: int, devices=None,
                     timeout: float = 300.0) -> dict:
    """One prepare and one trial of the sharded path on ``n_devices`` ranks
    (the JAX package's ``__graft_entry__.dryrun_multichip``), on a tiny
    synthetic problem, per configuration of DRYRUN_CONFIGS: float64
    cholesky, df32 cholesky (the chain kernels on CUDA), qrkit and spqr.

    ``devices``: one per rank; default ``cuda:0`` ... ``cuda:{n-1}`` (NCCL).
    Raises unless every energy is finite and every rank computed the same.
    Returns rank 0's {configuration: [energy, trial energy, rho
    denominator]}, its chain-kernel launches, and the backend."""
    if devices is None:
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                               f"CUDA devices, found {torch.cuda.device_count()}; "
                               "pass devices=['cpu', ...] for the CPU")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} ranks")
    outs = multihost.run_ranks(_dryrun_rank, devices, args=(n_devices,),
                               timeout=timeout)
    values = [{k: v for k, v in o.items() if k != "launches"} for o in outs]
    if any(v != values[0] for v in values):
        raise RuntimeError(f"dry run: the ranks disagree: {values}")
    return {**outs[0], "backend": multihost.backend_for(devices)}

"""Process groups for the sharded path: ``torch.distributed`` set up from
torchrun's environment, and local ranks started by this process.

One process per rank, as torchrun starts them (one per GPU):

    from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded
    multihost.initialize()            # MASTER_ADDR, MASTER_PORT, RANK, ...
    mesh = multihost.global_mesh()    # the world group and this rank's device
    sp = sharded.shard_problem(problem, mesh.size, mesh.rank, device=mesh.device)
    result = sharded.minimize_sharded(sp, mode="qrchol")

Every process builds the problem identically (the same BAL file);
``shard_problem`` keeps the rank's slice. The per-trial traffic is the
all-reduce of the (9N, 9N) reduced camera system and a few scalars: cameras
are replicated, so no per-observation data crosses ranks.

``run_ranks`` starts the ranks of one machine from a single process (the
command line's ``--shards``, the dry run, the tests): NCCL between distinct
GPUs, gloo on the CPU or where ranks share one GPU (NCCL refuses two ranks
on one device).
"""

from __future__ import annotations

import ctypes
import datetime
import math
import multiprocessing
import os
import queue
import shutil
import signal
import tempfile
import time
import traceback
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

#: Seconds a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT = 600.0


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT) -> bool:
    """``torch.distributed.init_process_group`` with torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT`` for ``env://``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``) as defaults. The backend is NCCL when
    CUDA is available, else gloo; with NCCL and ``LOCAL_RANK`` set the
    current device becomes ``cuda:LOCAL_RANK``. A no-op when a group is already up; with nothing
    configured (no ``init_method`` and no ``MASTER_ADDR``) it starts no
    group and the program runs as one process. Returns whether a group is
    up. Every collective of the group fails after ``timeout`` seconds."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            return False
        init_method = "env://"
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and "LOCAL_RANK" in env:
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


class Mesh(NamedTuple):
    """The ranks of the run: the world group (None without a group), this
    process's rank and the world size, and its device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def global_mesh() -> Mesh:
    """The world group and this rank's device: ``cuda:LOCAL_RANK`` where
    CUDA is available, else the CPU."""
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
              if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(group, rank, size, device)


def is_coordinator() -> bool:
    """True on the process that prints and writes (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def backend_for(devices) -> str:
    """NCCL where every rank has a GPU of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    distinct = len({(d.type, d.index) for d in devs}) == len(devs)
    return "nccl" if distinct and all(d.type == "cuda" for d in devs) else "gloo"


def _set_parent_death_signal() -> None:
    """Ask Linux to kill this rank when the process that started it dies."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _in_group(fn, rank, devices, backend, init_method, timeout, args):
    """``fn(rank, device, *args)`` inside the group, torn down after."""
    if dist.is_initialized():
        raise RuntimeError("run_ranks: this process already has a process group")
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(init_method, len(devices), rank, backend, timeout)
    try:
        return fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def _spawned(fn, rank, devices, backend, init_method, timeout, args, results):
    """A spawned rank: torchrun's environment variables, then its value or
    its traceback to the parent."""
    _set_parent_death_signal()
    device = torch.device(devices[rank])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(len(devices)),
                      LOCAL_RANK=str(device.index or 0))
    if device.type == "cpu":
        # The CPU's cores are shared: ranks that each spin a full thread
        # pool on small operations run ~4x slower (measured at 2 ranks).
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    try:
        value = _in_group(fn, rank, devices, backend, init_method, timeout, args)
        results.put((rank, True, value))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, devices, args=(), timeout: float = DEFAULT_TIMEOUT,
              deadline: Optional[float] = None) -> list:
    """Run ``fn(rank, device, *args)`` on ``len(devices)`` ranks of one
    process group, rank r on ``devices[r]``, and return their values in
    rank order.

    One rank runs in this process; more are spawned processes (``fn`` and
    ``args`` are pickled, ``fn`` by its module path, so it must live in a
    module that the ranks can import). The group meets in a file under a
    temporary directory; its backend is ``backend_for(devices)``.
    Every collective fails after ``timeout`` seconds, so a rank that hangs
    fails the group however long the run. ``deadline``, where given, bounds
    the whole run of spawned ranks in seconds; by default the run has none.
    On a failed rank, a failed collective or the deadline the other ranks
    are killed and this raises (RuntimeError with the rank's traceback,
    TimeoutError)."""
    n = len(devices)
    if n < 1:
        raise ValueError("run_ranks needs at least one device")
    backend = backend_for(devices)
    tmp = tempfile.mkdtemp(prefix="ba_ranks_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    try:
        if n == 1:
            return [_in_group(fn, 0, devices, backend, init_method, timeout, args)]
        return _spawn(fn, devices, backend, init_method, timeout, deadline, args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: Seconds to wait, after a rank fails, for the other ranks' failures: a
#: rank that fails takes its group down, and the others' errors (a closed
#: connection) can arrive before its own.
FAILURE_GRACE = 3.0


def _failures(results, n: int, rank: int, trace: str) -> str:
    """The report of a failed group: every failure that reaches the parent
    within FAILURE_GRACE seconds of the first, by rank."""
    failed = {rank: trace}
    deadline = time.monotonic() + FAILURE_GRACE
    while (left := deadline - time.monotonic()) > 0:
        try:
            r, ok, value = results.get(timeout=left)
        except queue.Empty:
            break
        if not ok:
            failed[r] = value
    return "\n".join(f"rank {r} of {n} failed:\n{failed[r]}" for r in sorted(failed))


def _spawn(fn, devices, backend, init_method, timeout, deadline, args) -> list:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_spawned, daemon=True,
                         args=(fn, r, devices, backend, init_method, timeout,
                               args, results))
             for r in range(len(devices))]
    values = {}
    end = math.inf if deadline is None else time.monotonic() + deadline
    try:
        for p in procs:
            p.start()
        while len(values) < len(procs):
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{len(procs)} ranks ({backend}) did not finish in "
                    f"{deadline:g} s; {sorted(values)} did")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in values and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0][0]} of {len(procs)} exited with code "
                        f"{dead[0][1]} without a result") from None
                continue
            if not ok:
                raise RuntimeError(_failures(results, len(procs), rank, value))
            values[rank] = value
        for p in procs:  # every rank has reported; let it exit
            p.join(5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
    return [values[r] for r in range(len(procs))]

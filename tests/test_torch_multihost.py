"""The port's process-group layer (``parallel/multihost.py``), its sharded
path at D = 4 against the JAX package's, and the command line's
``--shards`` against the JAX command line's, on the CPU.

The D = 4 ranks run every case of the file once (the module fixture
``ranks4``); tolerances as in test_torch_sharded.py. Every spawned group
and subprocess has a timeout, so a hang fails one test.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu import cli as jcli
from bundleadjustment_benchmarks_tpu_torch import cli
from bundleadjustment_benchmarks_tpu_torch.parallel import multihost

import torch_sharded_worker as worker
from test_torch_cli import (ROOT, TAU, Run, assert_same, run_cli,
                            write_synthetic_bal)
from test_torch_sharded import (MODES, TIMEOUT, assert_prepare,
                                assert_ranks_identical, assert_trial,
                                jax_step, problem_arrays, step_cases)

D = 4
#: The D = 2 file also runs "mixed" (shards without pairs of their own).
STEP_PROBLEMS = ("syn2", "skew")


@pytest.fixture(scope="module")
def ranks4():
    return multihost.run_ranks(worker.cases, ["cpu"] * D,
                               args=(step_cases(STEP_PROBLEMS),
                                     problem_arrays(STEP_PROBLEMS)),
                               timeout=TIMEOUT)


@pytest.mark.parametrize("mode", MODES)
def test_prepare_matches_jax_d4(ranks4, mode):
    assert_prepare(ranks4[0][f"trial-{mode}-syn2"],
                   jax_step("syn2", D, mode, 0.05), f"D={D} {mode}")


@pytest.mark.parametrize("prob", STEP_PROBLEMS)
@pytest.mark.parametrize("mode", MODES)
def test_trial_matches_jax_d4(ranks4, mode, prob):
    assert_trial(ranks4[0][f"trial-{mode}-{prob}"],
                 jax_step(prob, D, mode, 0.05), f"D={D} {mode} {prob}")


def test_every_rank_identical_d4(ranks4):
    assert_ranks_identical(ranks4)


def test_run_ranks_all_reduce_and_coordinator():
    """Two spawned gloo ranks: the all-reduce agrees on both, exactly one
    is the coordinator, and each sees the whole group."""
    outs = multihost.run_ranks(worker.group_all_reduce, ["cpu", "cpu"],
                               timeout=TIMEOUT)
    assert [o["sum"] for o in outs] == [3.0, 3.0]
    assert [o["coordinator"] for o in outs] == [True, False]
    assert [(o["rank"], o["size"]) for o in outs] == [(0, 2), (1, 2)]
    assert len({o["pid"] for o in outs} | {os.getpid()}) == 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_from_torchrun_environment():
    """Two processes started as torchrun starts them (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): ``multihost.initialize(backend="gloo")``
    forms the group from the environment; the all-reduce agrees; one
    coordinator."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_sharded_worker.py")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [o["sum"] for o in outs] == [3.0, 3.0]
    assert sorted(o["coordinator"] for o in outs) == [False, True]


def test_initialize_without_configuration_runs_alone(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(backend="gloo") is False
    assert not dist.is_initialized()
    mesh = multihost.global_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1,
                                                               torch.device("cpu"))
    assert multihost.is_coordinator()


@pytest.mark.parametrize("call", ["initialize", "global_mesh"])
def test_no_cuda_and_no_explicit_cpu_choice_raises(monkeypatch, call):
    """Without CUDA, ``initialize()`` with no backend and ``global_mesh()``
    with no device raise, naming the CPU choice, and start nothing; the
    explicit choice runs."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(multihost, call)
    with pytest.raises(RuntimeError, match="gloo" if call == "initialize" else "cpu"):
        fn()
    assert not dist.is_initialized()
    if call == "initialize":
        assert fn(backend="gloo") is False
    else:
        assert fn(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("omp", [None, "3"])
def test_spawned_cpu_ranks_split_the_cpus(omp):
    """A spawned CPU rank takes ``cpu_count // len(devices)`` threads where
    no OMP_NUM_THREADS is set (a user's run, in a fresh environment), and
    the inherited value where it is lower."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    if omp is not None:
        env["OMP_NUM_THREADS"] = omp
    env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])
    code = ("import json\n"
            "from bundleadjustment_benchmarks_tpu_torch.parallel import multihost\n"
            "import torch_sharded_worker as worker\n"
            "print(json.dumps(multihost.run_ranks(worker.num_threads, ['cpu', 'cpu'],\n"
            "                                     timeout=120.0)))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    split = max(1, (os.cpu_count() or 1) // 2)
    want = split if omp is None else min(split, int(omp))
    assert json.loads(proc.stdout.splitlines()[-1]) == [want, want]


def test_failed_rank_fails_the_group():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*on purpose"):
        multihost.run_ranks(worker.fail_on_rank_1, ["cpu", "cpu"], timeout=TIMEOUT)


def test_hung_rank_times_out():
    """Rank 0 waits in an all-reduce that rank 1 never joins: the run ends
    at its timeout and kills both."""
    with pytest.raises((TimeoutError, RuntimeError)):
        multihost.run_ranks(worker.hang_on_rank_1, ["cpu", "cpu"], timeout=6.0)


def test_run_outlasts_the_collective_timeout():
    """Two ranks whose run (~6 s of fast all-reduces) lasts twice the
    collective timeout (3 s) finish: the timeout bounds each collective,
    not the run, which has no deadline unless one is given."""
    outs = multihost.run_ranks(worker.all_reduce_for, ["cpu", "cpu"],
                               args=(60, 0.1), timeout=3.0)
    assert [o["value"] for o in outs] == [2.0 ** 60] * 2
    assert min(o["seconds"] for o in outs) > 3.0


def test_deadline_bounds_the_run():
    """A deadline given to ``run_ranks`` ends a run that outlasts it."""
    with pytest.raises(TimeoutError, match="did not finish in 2 s"):
        multihost.run_ranks(worker.all_reduce_for, ["cpu", "cpu"],
                            args=(100, 0.1), timeout=30.0, deadline=2.0)


def test_backend_for():
    assert multihost.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert multihost.backend_for(["cuda:0"]) == "nccl"
    assert multihost.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert multihost.backend_for(["cpu", "cpu"]) == "gloo"


# -- the command line ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_synthetic_bal(str(tmp_path_factory.mktemp("bal") / "tiny.txt"))


def run_port_shards(args, tmp_path, tag, metrics: bool = True) -> Run:
    """The port's command line with --shards in a subprocess (its ranks
    print to the process's stdout), with a timeout; with --metrics unless
    ``metrics`` is False."""
    m = str(tmp_path / f"{tag}.jsonl") if metrics else None
    proc = subprocess.run(
        [sys.executable, "-m", "bundleadjustment_benchmarks_tpu_torch.cli", *args,
         "--device", "cpu", *(["--metrics", m] if m else []),
         "--log-file", str(tmp_path / f"{tag}.log")],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    return Run(proc.returncode, proc.stdout, m)


#: The sharded cholesky run's records against JAX's: f within 1e-6. JAX's
#: own --shards 2 and single-device records of this file differ by 2.6e-7
#: (cholesky's first lambda is ~1e-12 of the largest column norm, so the
#: first steps follow the summation order), the port's and JAX's sharded
#: ones by 2.8e-7; qrkit, spqr and moreqr by <= 3e-10.
SHARDED_RTOL_F = 1e-6
SHARDED_ARGS = ["--solver", "cholesky", "--max-iters", "8", "--checkpoint-every",
                "3", "--shards", "2"] + TAU


@pytest.fixture(scope="module")
def sharded_run(tiny, tmp_path_factory):
    """The port's --shards 2 run of the tiny file, 8 iterations."""
    return run_port_shards([tiny] + SHARDED_ARGS, tmp_path_factory.mktemp("cli"),
                           "whole")


def test_cli_shards_matches_jax(tiny, sharded_run, tmp_path, capsys):
    """``--shards 2 --device cpu`` prints the JAX command line's lines and
    table rows (``--shards 2`` on its virtual mesh), the records' values to
    test_torch_cli.py's tolerances with f to SHARDED_RTOL_F."""
    ref = run_cli("jax", [tiny] + SHARDED_ARGS, tmp_path, capsys, "jax")
    assert_same(sharded_run, ref, "--shards 2 cholesky", rtol_f=SHARDED_RTOL_F)
    assert sharded_run.lines[0] == \
        "N(cameras) = 6, M(points) = 40, K(measurements) = 160"


def test_cli_shards_jit_matches_jax(tiny, tmp_path, capsys):
    """``--shards 2 --drive jit --device cpu`` against the JAX command
    line's ``--shards 2 --drive jit`` (its lm_loop on the virtual mesh):
    the same lines (header, statistics, status, post statistics) and, as
    there, no iteration table."""
    args = [tiny, "--solver", "cholesky", "--max-iters", "8", "--shards", "2",
            "--drive", "jit"] + TAU
    port = run_port_shards(args, tmp_path, "port", metrics=False)
    capsys.readouterr()
    try:
        rc = jcli.main(args + ["--log-file", str(tmp_path / "jax.log")])
    finally:
        jax.config.update("jax_enable_x64", True)
    ref = Run(rc, capsys.readouterr().out)
    assert port.rc == ref.rc == cli.RETURN_SUCCESS
    assert port.lines == ref.lines
    assert port.rows == ref.rows == []
    assert port.lines[-4].startswith("LM finished with status")


def test_cli_shards_checkpoint_resumes_on_one_device(tiny, sharded_run, tmp_path,
                                                     capsys):
    """A checkpoint written by --shards 2 resumes without --shards and
    continues as the uninterrupted sharded run did."""
    ck = str(tmp_path / "ck.npz")
    args = [tiny] + SHARDED_ARGS
    args[args.index("8")] = "5"
    run_port_shards(args + ["--checkpoint", ck], tmp_path, "first")
    resumed = run_cli("port", [tiny, "--max-iters", "8", "--checkpoint", ck,
                               "--checkpoint-every", "3"] + TAU,
                      tmp_path, capsys, "resumed")
    assert resumed.rc == cli.RETURN_SUCCESS
    assert resumed.lines[4] == f"Resuming from {ck} (iteration 3)"
    assert [r[:2] for r in resumed.rows] == [r[:2] for r in sharded_run.rows
                                             if r[0] > 3]
    assert resumed.lines[5:] == sharded_run.lines[4:]


@pytest.mark.parametrize("case", ["negative", "cuda without a card", "no device"])
def test_cli_shards_refused(tiny, tmp_path, capsys, case):
    """--shards is refused (return code 1, nothing run) for a negative
    count, and without CUDA where --device asks for it or is not given; it
    never runs on one device in place of N shards."""
    log = ["--log-file", str(tmp_path / "run.log")]
    if case != "negative" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"negative": [tiny, "--shards", "-1", "--device", "cpu"],
            "cuda without a card": [tiny, "--shards", "2", "--device", "cuda"],
            "no device": [tiny, "--shards", "2"]}[case]
    assert cli.main(argv + log) == cli.RETURN_WRONG_INPUT_PARAMS
    captured = capsys.readouterr()
    assert "N(cameras)" not in captured.out
    assert captured.err


def test_cli_shards_need_a_gpu_per_rank(monkeypatch, capsys):
    """With fewer GPUs than ranks the command line refuses (the JAX one
    refuses fewer devices than shards); one rank takes the given device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli._shard_devices(2, torch.device("cuda", 0)) is None
    assert "--shards 2 needs 2 CUDA devices" in capsys.readouterr().err
    assert cli._shard_devices(1, torch.device("cuda", 1)) == ["cuda:1"]
    assert cli._shard_devices(3, torch.device("cpu")) == ["cpu"] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli._shard_devices(2, torch.device("cuda", 0)) == ["cuda:0", "cuda:1"]

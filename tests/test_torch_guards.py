"""Guards of the port: it never imports JAX, its entry points run on CUDA
unless the caller names a device, and the kernels are never swapped for
their plain versions behind the caller's back."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import torch_threads  # sizes torch's thread pool to the xdist worker

from bundleadjustment_benchmarks_tpu_torch import convert, resolve_device
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.parallel import multihost
from bundleadjustment_benchmarks_tpu_torch.solvers import lm

import torch_sharded_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")
CAMPAIGN = os.path.join(ROOT, "flatline_campaign.py")
ELLIPSE = os.path.join(ROOT, "examples", "ellipse_fitting_torch.py")
ORACLE = os.path.join(ROOT, "oracle_prefix.py")
BENCH = os.path.join(ROOT, "bench_torch.py")
PROBE = os.path.join(ROOT, "numerics_probe.py")
STAGE = os.path.join(ROOT, "stage_profile.py")
THREADS_HELPER = os.path.join(ROOT, "tests", "torch_threads.py")
P16 = os.path.join(ROOT, "data", "problem-16-22106-pre.txt.gz")


def _is_jax_side(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "jaxlib" \
        or name.startswith("jaxlib.") \
        or name == "bundleadjustment_benchmarks_tpu" \
        or name.startswith("bundleadjustment_benchmarks_tpu.")


def test_port_modules_import_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import bundleadjustment_benchmarks_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    for name in ("solvers.lm", "convert", "cli", "utils.stats",
                 "utils.logger", "utils.checkpoint", "utils.synthetic",
                 "utils.balgen", "models.camera", "solvers.norms",
                 "parallel.sharded", "parallel.multihost"):
        assert f"bundleadjustment_benchmarks_tpu_torch.{name}" in out
    assert [m for m in out if _is_jax_side(m)] == []


def test_every_mode_runs_without_jax():
    """Each solver mode on both geometry drives (float64, df32) and both
    LM drives (host, jit), with and without the pair tables, in a fresh
    process on a small problem made with numpy: no JAX module is loaded."""
    code = (
        "import dataclasses, sys\n"
        "import numpy as np\n"
        "from bundleadjustment_benchmarks_tpu_torch.io.bal import BalDataset\n"
        "from bundleadjustment_benchmarks_tpu_torch.models import problem as pm\n"
        "from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur\n"
        "rng = np.random.default_rng(0)\n"
        "n, m = 4, 30\n"
        "cam = np.concatenate([rng.permutation(n)[:3] for _ in range(m)])\n"
        "pts = np.repeat(np.arange(m), 3)\n"
        "ds = BalDataset(cam_idx=cam.astype(np.int32), pt_idx=pts.astype(np.int32),\n"
        "    measurements=rng.normal(scale=50.0, size=(3 * m, 2)),\n"
        "    omega=rng.normal(scale=0.1, size=(n, 3)),\n"
        "    translation=np.c_[rng.normal(scale=0.1, size=(n, 2)), np.full(n, 2.0)],\n"
        "    focal=rng.uniform(400, 600, n), k1=np.zeros(n), k2=np.zeros(n),\n"
        "    points=rng.normal(scale=0.3, size=(m, 3)))\n"
        "prob = pm.from_bal_dataset(ds, inlier_threshold=1e4, device='cpu')\n"
        "for mode in schur.MODES:\n"
        "    for kw in ({}, dict(matmul_dtype='float32', geometry='df32')):\n"
        "        for p in (prob, dataclasses.replace(prob, pairs=None)):\n"
        "            for drive in ('host', 'jit'):\n"
        "                res = lm.minimize(p, mode=mode, device='cpu', config=\n"
        "                    lm.LMConfig(drive=drive, max_iter=2, **kw))\n"
        "                assert np.isfinite(res.energy), (mode, kw, p.pairs)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "bundleadjustment_benchmarks_tpu_torch.solvers.schur" in out
    assert [m for m in out if _is_jax_side(m)] == []


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(SMOKE).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "bundleadjustment_benchmarks_tpu_torch.solvers" in names
    assert [n for n in names if _is_jax_side(n)] == []


def _imported_names(path):
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", [CAMPAIGN, ELLIPSE, ORACLE, BENCH, PROBE, STAGE],
                         ids=os.path.basename)
def test_campaign_and_example_import_no_jax(path):
    """The flatline campaign, the ellipse example, the oracle-prefix script,
    the bench, the numerics probe and the kernel profiler name no JAX
    module, and importing them (and the package modules they reach) loads
    none."""
    names = _imported_names(path)
    assert "bundleadjustment_benchmarks_tpu_torch.solvers" in names
    assert [n for n in names if _is_jax_side(n)] == []
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "m.drive_config('df32p', 3) if hasattr(m, 'drive_config') else None\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "bundleadjustment_benchmarks_tpu_torch.solvers.lm" in out
    assert [m for m in out if _is_jax_side(m)] == []


PORT_FILES = sorted(
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(ROOT, "bundleadjustment_benchmarks_tpu_torch"))
    for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", [SMOKE, CAMPAIGN, ORACLE, BENCH, PROBE, STAGE,
                                  *PORT_FILES],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_nothing_of_the_port_imports_jax_reference(path):
    """``jax_reference.py`` runs the JAX package to write the Ladybug
    reference; the port, its scripts and chip_smoke.py never import it."""
    assert "jax_reference" not in _imported_names(path)


def test_campaign_needs_cuda_unless_told(tmp_path):
    """Without CUDA and without ``--device cpu`` the campaign exits non-zero
    and runs and writes nothing; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "rows.json"
    proc = subprocess.run([sys.executable, CAMPAIGN, "--problems", "p16",
                           "--modes", "cholesky", "--drives", "f64",
                           "--json", str(out)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == "" and not out.exists()


def test_oracle_prefix_needs_cuda_unless_told(tmp_path):
    """``oracle_prefix.run`` without a device raises where there is no CUDA,
    before it loads or runs anything, and the script exits 2 and writes
    nothing; neither falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sys.path.insert(0, ROOT)
    import oracle_prefix

    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle_prefix.run(("p257",), device=None)
    out = tmp_path / "rows.json"
    proc = subprocess.run([sys.executable, ORACLE, "--key", "p257", "--json",
                           str(out)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == "" and not out.exists()


def test_bench_needs_cuda_unless_told():
    """Without CUDA and without ``--device`` the bench exits 2 and prints
    nothing on its standard output; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, BENCH, "--problem", "p16",
                           "--modes", "cholesky", "--max-iter", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_numerics_probe_needs_cuda_unless_told():
    """Without CUDA and without ``--device`` the numerics probe exits 2 and
    prints nothing on its standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, PROBE, "--runs", "p16-f64"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_stage_profile_fails_without_cuda():
    """Without CUDA the kernel profiler exits non-zero and prints nothing on
    its standard output; it never times on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, STAGE, "--chain"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "needs a CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["load_bal_problem", "problem_from_numpy",
                                   "state_from_numpy", "minimize"])
def test_loaders_and_minimize_raise_without_cuda(entry):
    """Each entry point raises with no CUDA device and no ``device``; given
    ``device="cpu"`` it builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prob = pm.load_bal_problem(P16, device="cpu")
    d = convert.problem_to_numpy(prob)
    calls = {
        "load_bal_problem": lambda **kw: pm.load_bal_problem(P16, **kw),
        "problem_from_numpy": lambda **kw: convert.problem_from_numpy(d, **kw),
        "state_from_numpy": lambda **kw: convert.state_from_numpy(
            convert.state_to_numpy(prob.state), **kw),
        "minimize": lambda **kw: lm.minimize(
            prob, config=lm.LMConfig(max_iter=0), **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    out = calls[entry](device="cpu")
    t = out.state.T if hasattr(out, "state") else out.T
    assert t.device == torch.device("cpu")


@pytest.mark.parametrize("mode", ["QRKIT", "householder"])
def test_unknown_mode_raises(mode):
    """A mode that does not exist is refused, never replaced."""
    prob = pm.load_bal_problem(P16, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        lm.minimize(prob, mode=mode, device="cpu",
                    config=lm.LMConfig(max_iter=1))


def test_kernels_on_cpu_raise():
    cfg = lm.LMConfig(geometry="df32", kernels=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cfg.use_kernels(torch.device("cpu"))


@pytest.mark.parametrize("geometry,kernels,device,want", [
    ("df32", None, "cuda", True),
    ("df32", None, "cpu", False),
    ("df32", False, "cuda", False),
    (None, None, "cuda", True),
])
def test_kernels_default_follows_device(geometry, kernels, device, want):
    cfg = lm.LMConfig(geometry=geometry, kernels=kernels)
    assert cfg.use_kernels(torch.device(device)) is want


def test_f64_kernels_on_cpu_raise():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        lm.LMConfig(kernels=True).use_kernels(torch.device("cpu"))


@pytest.mark.parametrize("matmul_dtype,kernels,dtype,device,want", [
    (None, None, torch.float64, "cuda", True),
    (None, True, torch.float64, "cuda", True),
    (None, False, torch.float64, "cuda", False),
    (None, None, torch.float64, "cpu", False),
    (None, None, torch.float32, "cuda", False),
    (None, True, torch.float32, "cuda", False),
    ("float32", None, torch.float64, "cuda", False),
    ("float32", True, torch.float64, "cuda", False),
], ids=["default", "asked", "plain", "cpu", "f32-state", "f32-state-asked",
        "mixed", "mixed-asked"])
def test_f64_kernels_follow_state_and_matmul(matmul_dtype, kernels, dtype,
                                             device, want):
    """The float64 drive's kernels engage only for a float64 state with
    geometry and matmul_dtype None on CUDA; ``kernels=False`` keeps the
    plain path there."""
    cfg = lm.LMConfig(matmul_dtype=matmul_dtype, kernels=kernels)
    assert cfg.use_kernels(torch.device(device), dtype) is want


def test_f64_kernel_path_wiring_on_cpu(monkeypatch):
    """Where the float64 drive takes the kernels, every prepare goes through
    ``cuda_chain.blocks_energy_f64`` and every trial's energy through
    ``cuda_chain.energy_f64`` (forced here on the CPU, where the entry
    points are the plain chain), on both drives; the LM path is the plain
    drive's, its energy within 1e-12 (the blocks reach build_context as
    views of planar rows)."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain
    from bundleadjustment_benchmarks_tpu_torch.utils.synthetic import (
        make_synthetic_problem)

    prob = make_synthetic_problem(n_cameras=5, n_points=40, obs_per_point=4,
                                  seed=4, device="cpu")
    cfg = lm.LMConfig(max_iter=4, drive="host")
    plain = lm.minimize(prob, config=cfg, device="cpu")
    calls = {"blocks": 0, "energy": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cuda_chain, "blocks_energy_f64",
                        counted("blocks", cuda_chain.blocks_energy_f64))
    monkeypatch.setattr(cuda_chain, "energy_f64",
                        counted("energy", cuda_chain.energy_f64))
    monkeypatch.setattr(lm.LMConfig, "use_kernels", lambda self, *a: True)
    for drive in ("host", "jit"):
        calls.update(blocks=0, energy=0)
        res = lm.minimize(prob, config=lm.LMConfig(max_iter=4, drive=drive),
                          device="cpu")
        assert (res.iterations, res.fun_evals, res.status) == (
            plain.iterations, plain.fun_evals, plain.status), drive
        assert abs(res.energy - plain.energy) <= 1e-12 * plain.energy, drive
        assert calls["energy"] == res.fun_evals - calls["blocks"] > 0, drive
        assert 0 < calls["blocks"] <= res.iterations, drive


@pytest.mark.parametrize("environ,cpus,want", [
    ({}, 8, 8),
    ({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8, 2),
    ({"PYTEST_XDIST_WORKER_COUNT": "6"}, 64, 10),
    ({"PYTEST_XDIST_WORKER_COUNT": "16"}, 8, 2),
    ({"OMP_NUM_THREADS": "4"}, 8, 4),
    ({"OMP_NUM_THREADS": "3,1"}, 8, 3),
    ({"OMP_NUM_THREADS": "1"}, 8, 2),
    ({"OMP_NUM_THREADS": "16", "PYTEST_XDIST_WORKER_COUNT": "2"}, 8, 4),
    ({"OMP_NUM_THREADS": "0"}, 8, 8),
    ({"OMP_NUM_THREADS": "many"}, 8, 8),
])
def test_thread_count_rule(environ, cpus, want):
    """The CPUs shared among the xdist workers, lowered to the caller's
    OMP_NUM_THREADS, never below 2 threads."""
    assert torch_threads.threads_for(environ, cpus) == want


def test_torch_threads_sized_to_the_worker():
    """This worker's pool is the helper's count, at least 2 threads."""
    assert torch_threads.THREADS >= torch_threads.FLOOR == 2
    assert torch.get_num_threads() == torch_threads.THREADS


def test_thread_cap_exported_to_children():
    """A process a test starts inherits the cap through OMP_NUM_THREADS
    (and MKL_NUM_THREADS): the helper's count unless the caller set one."""
    assert all(name in os.environ for name in torch_threads.EXPORTED)
    if not torch_threads.INHERITED:
        assert os.environ["OMP_NUM_THREADS"] == str(torch_threads.THREADS)
    out = subprocess.run([sys.executable, "-c",
                          "import torch; print(torch.get_num_threads())"],
                         check=True, capture_output=True, text=True, timeout=120)
    assert int(out.stdout) == int(os.environ["OMP_NUM_THREADS"].split(",")[0])


def test_spawned_ranks_keep_the_exported_cap():
    """Two gloo ranks that ``multihost.run_ranks`` spawns on the CPU run no
    more threads each than the cap they inherit."""
    cap = int(os.environ["OMP_NUM_THREADS"].split(",")[0])
    outs = multihost.run_ranks(worker.num_threads, ["cpu", "cpu"], timeout=120.0)
    assert len(outs) == 2 and all(1 <= n <= cap for n in outs), (outs, cap)


def test_torch_threads_imports_no_jax():
    """The helper names no JAX module, and importing it loads none."""
    assert "torch" in _imported_names(THREADS_HELPER)
    assert [n for n in _imported_names(THREADS_HELPER) if _is_jax_side(n)] == []
    code = ("import sys\n"
            "import torch_threads\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.dirname(THREADS_HELPER)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120).stdout.split()
    assert "torch_threads" in out
    assert [m for m in out if _is_jax_side(m)] == []

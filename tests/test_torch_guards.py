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

from bundleadjustment_benchmarks_tpu_torch import convert, resolve_device
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.solvers import lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")
CAMPAIGN = os.path.join(ROOT, "flatline_campaign.py")
ELLIPSE = os.path.join(ROOT, "examples", "ellipse_fitting_torch.py")
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
    """Each solver mode on both drives, with and without the pair tables,
    in a fresh process on a small problem made with numpy: no JAX module
    is loaded."""
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
        "            res = lm.minimize(p, mode=mode, device='cpu',\n"
        "                              config=lm.LMConfig(max_iter=2, **kw))\n"
        "            assert np.isfinite(res.energy), (mode, kw, p.pairs)\n"
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


@pytest.mark.parametrize("path", [CAMPAIGN, ELLIPSE], ids=os.path.basename)
def test_campaign_and_example_import_no_jax(path):
    """The flatline campaign and the ellipse example name no JAX module,
    and importing them (and the package modules they reach) loads none."""
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


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


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
    (None, None, "cuda", False),
])
def test_kernels_default_follows_device(geometry, kernels, device, want):
    cfg = lm.LMConfig(geometry=geometry, kernels=kernels)
    assert cfg.use_kernels(torch.device(device)) is want

"""The port's command line (``--device cpu``) against the JAX package's
(``--drive host``) on the same BAL files, in-process on the CPU.

Held equal: return codes; the header, statistics, status and "Resuming
from" lines, as strings; the iteration tables' (iter, status) rows; the
JSONL metrics records' (iter, status, phase). Held to a tolerance, in the
table and in the records (Elapsed is not compared):

- f within 1e-7 relative and lambda within 1e-8. The packages' damped
  steps differ by ~1e-10 relative (ROADMAP Queue 3), and a step that lowers
  the energy 100-fold carries that into the next f 100-fold: measured 2.9e-8
  (tiny file, cholesky, iteration 3), 1.5e-8 on p16. lambda moves by rho's
  gap through the Nielsen factor (8.3e-10 measured) and is exact through
  its 1/3 clamp.
- rho within 1e-7 relative on the steps that lower the energy by at least
  1e-3 of it. On the flatline steps (relative decreases ~1e-5 and below)
  the predicted decrease is formed from a gradient at rounding level, and
  rho differs by up to 8e-4 between the packages, as between JAX's own
  modes; the accept decisions and the table rows still agree.

Gaps print with ``pytest -rP``."""

import json
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bundleadjustment_benchmarks_tpu import cli as jcli
from bundleadjustment_benchmarks_tpu_torch import cli
from bundleadjustment_benchmarks_tpu_torch.io import bal
from bundleadjustment_benchmarks_tpu_torch.ops import rodrigues
from bundleadjustment_benchmarks_tpu_torch.solvers import lm
from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P16 = os.path.join(ROOT, "data", "problem-16-22106-pre.txt.gz")
SOLVERS = ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")
RTOL_F, RTOL_LAMBDA, RTOL_RHO = 1e-7, 1e-8, 1e-7
#: rho is compared on steps that lower the energy by at least this fraction.
RHO_RESOLVED = 1e-3
ROW = re.compile(r"^\s*(\d+)\s+(Accepted|Rejected)\s+(\S+)\s+(\S+)\s+(\S+)\s+\S+s$")
KEPT = ("N(cameras)", "Mean reprojection error", "Inlier mean reprojection",
        "True objective", "LM finished with status", "Resuming from")


def write_synthetic_bal(path, n_cameras=6, n_points=40, obs_per_point=4,
                        seed=1):
    """A small synthetic problem written as BAL text by the port."""
    prob = synthetic.make_synthetic_problem(n_cameras=n_cameras,
                                            n_points=n_points,
                                            obs_per_point=obs_per_point,
                                            seed=seed, device="cpu")
    st, obs = prob.state, prob.obs
    f = -st.K[:, 0, 0].numpy()
    bal.write_bal(path, bal.BalDataset(
        cam_idx=obs.cam_idx.numpy(), pt_idx=obs.pt_idx.numpy(),
        measurements=obs.measurements.numpy(),
        omega=rodrigues.log_rodrigues(st.R).numpy(), translation=st.T.numpy(),
        focal=f, k1=st.k1.numpy() / f**2, k2=st.k2.numpy() / f**4,
        points=st.points.numpy()))
    return path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """6 cameras, 40 points, 160 observations: the LM parity tests' problem
    (test_torch_lm.py), run at tau = 2 px (``TAU``). On a smaller one (4
    cameras, 15 points, 3 observations each) the first-iteration lambda is
    3e-7, the damped steps are gauge-dominated, and the packages' steps,
    like JAX's cholesky and qrchol steps, differ by ~1e-6."""
    return write_synthetic_bal(str(tmp_path_factory.mktemp("bal") / "tiny.txt"))


TAU = ["--inlier-threshold", "2.0"]


class Run:
    """One CLI run: return code, output, the kept lines, the table rows and
    the metrics records."""

    def __init__(self, rc, out, metrics_path=None):
        self.rc, self.out = rc, out
        lines = out.splitlines()
        self.lines = [ln for ln in lines if ln.startswith(KEPT)]
        # rho "-": a Rejected row that the jit drive synthesized.
        self.rows = [(int(m[1]), m[2], float(m[3]),
                      None if m[4] == "-" else float(m[4]), float(m[5]))
                     for m in map(ROW.match, lines) if m]
        self.records = []
        if metrics_path and os.path.exists(metrics_path):
            with open(metrics_path) as f:
                self.records = [json.loads(ln) for ln in f]

    def objective(self, which):
        """The pre (0) or post (-1) "True objective"."""
        return float([ln for ln in self.lines
                      if ln.startswith("True objective")][which].split()[-1])


def run_cli(which, args, tmp_path, capsys, tag, metrics=True):
    capsys.readouterr()
    extra = ["--log-file", str(tmp_path / f"{tag}.log")]
    m = str(tmp_path / f"{tag}.jsonl") if metrics else None
    if m:
        extra += ["--metrics", m]
    if which == "jax":
        try:
            rc = jcli.main(args + extra + ["--drive", "host"])
        finally:
            jax.config.update("jax_enable_x64", True)
    else:
        rc = cli.main(args + extra + ["--device", "cpu"])
    return Run(rc, capsys.readouterr().out, m)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _gaps(port_vals, ref_vals):
    """Max relative gap of f, rho, lambda over aligned (f, rho, lambda)
    triples, rho only on resolved descent steps: a step resolves where the
    next triple's f (the energy it reached) is at most (1 - RHO_RESOLVED)
    of its own."""
    g = {"f": 0.0, "rho": 0.0, "lambda": 0.0}
    for i, (p, r) in enumerate(zip(port_vals, ref_vals)):
        g["f"] = max(g["f"], _rel(p[0], r[0]))
        g["lambda"] = max(g["lambda"], _rel(p[2], r[2]))
        nxt = ref_vals[i + 1][0] if i + 1 < len(ref_vals) else r[0]
        if nxt <= (1.0 - RHO_RESOLVED) * r[0]:
            g["rho"] = max(g["rho"], _rel(p[1], r[1]))
    return g


def assert_same(port: Run, ref: Run, label: str, rtol_f: float = RTOL_F):
    assert port.rc == ref.rc == cli.RETURN_SUCCESS
    assert port.lines == ref.lines
    assert [r[:2] for r in port.rows] == [r[:2] for r in ref.rows]
    key = ("iter", "status", "phase")
    assert [[r.get(k) for k in key] for r in port.records] == \
        [[r.get(k) for k in key] for r in ref.records]
    for what, p_vals, r_vals in (
            ("table", [r[2:] for r in port.rows], [r[2:] for r in ref.rows]),
            ("records", [(r["f"], r["rho"], r["lambda"]) for r in port.records],
             [(r["f"], r["rho"], r["lambda"]) for r in ref.records])):
        g = _gaps(p_vals, r_vals)
        print(f"gap CLI {label} {what}: {len(p_vals)} trials, relative f "
              f"{g['f']:.3g}, rho {g['rho']:.3g}, lambda {g['lambda']:.3g}")
        assert g["f"] <= rtol_f and g["lambda"] <= RTOL_LAMBDA
        assert g["rho"] <= RTOL_RHO


@pytest.mark.parametrize("solver", SOLVERS)
def test_cli_matches_jax_tiny(tiny, tmp_path, capsys, solver):
    args = [tiny, "--solver", solver, "--max-iters", "10"] + TAU
    ref = run_cli("jax", args, tmp_path, capsys, "jax")
    port = run_cli("port", args, tmp_path, capsys, "port")
    assert_same(port, ref, f"tiny {solver}")
    assert port.rows and port.lines[0] == \
        "N(cameras) = 6, M(points) = 40, K(measurements) = 160"


def test_cli_matches_jax_p16(tmp_path, capsys):
    args = [P16, "--solver", "cholesky", "--max-iters", "2"]
    ref = run_cli("jax", args, tmp_path, capsys, "jax")
    port = run_cli("port", args, tmp_path, capsys, "port")
    assert_same(port, ref, "p16 cholesky")
    assert port.lines[0] == \
        "N(cameras) = 16, M(points) = 22106, K(measurements) = 77392"
    assert port.lines[-1] == ref.lines[-1]
    assert port.objective(-1) < port.objective(0)
    log = open(tmp_path / "port.log").read().splitlines()
    assert [ln.split("] ", 1)[1] for ln in log] == [
        "Info: Computation STARTED!", "Info: Computation DONE!"]


def test_checkpoint_resume_equals_uninterrupted(tiny, tmp_path, capsys):
    """Checkpoint every 3, stop at 5, resume to 8: the same iterations,
    evaluations, status and energy (1e-12) as one run of 8, and the resumed
    table and records continue the uninterrupted run's."""
    ck = str(tmp_path / "ck.npz")
    args = [tiny, "--checkpoint-every", "3"] + TAU
    whole = run_cli("port", args + ["--max-iters", "8"], tmp_path, capsys, "whole")
    first = run_cli("port", args + ["--max-iters", "5", "--checkpoint", ck],
                    tmp_path, capsys, "first")
    assert checkpoint.load_checkpoint(ck, device="cpu")[1]["iteration"] == 3
    resumed = run_cli("port", args + ["--max-iters", "8", "--checkpoint", ck],
                      tmp_path, capsys, "resumed")
    assert first.rows[0][0] == 1 and resumed.rows[0][0] == 4
    assert resumed.lines[4] == f"Resuming from {ck} (iteration 3)"
    assert resumed.lines[5:] == whole.lines[4:]
    cut = len([r for r in whole.records if r["iter"] <= 3])
    assert [(r["iter"], r["status"], r["f"], r["lambda"])
            for r in resumed.records] == [
        (r["iter"], r["status"], r["f"], r["lambda"])
        for r in whole.records[cut:]]

    # The same through lm.minimize: the result's bookkeeping.
    prob = synthetic.make_synthetic_problem(n_cameras=6, n_points=40,
                                            obs_per_point=4, seed=1,
                                            inlier_threshold=2.0, device="cpu")
    ck2 = str(tmp_path / "ck2.npz")
    cfg = lm.LMConfig(max_iter=8)
    ref = lm.minimize(prob, config=cfg, device="cpu")
    lm.minimize(prob, config=lm.LMConfig(max_iter=5), device="cpu",
                checkpoint_path=ck2, checkpoint_every=3)
    state, meta = checkpoint.load_checkpoint(ck2, device="cpu")
    res = lm.minimize(prob, config=cfg, state=state, resume=meta, device="cpu")
    print(f"resume: iterations {res.iterations}, fun_evals {res.fun_evals}, "
          f"energy gap {_rel(res.energy, ref.energy):.3g}")
    assert (res.iterations, res.fun_evals, res.status) == (
        ref.iterations, ref.fun_evals, ref.status)
    assert _rel(res.energy, ref.energy) <= 1e-12


def test_resume_from_jax_checkpoint(tiny, tmp_path, capsys):
    """The port resumed from a checkpoint the JAX CLI wrote runs as JAX's
    own resume does."""
    ck_j, ck_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    args = [tiny, "--checkpoint-every", "3"] + TAU
    run_cli("jax", args + ["--max-iters", "3", "--checkpoint", ck_j],
            tmp_path, capsys, "jax0")
    shutil.copy(ck_j, ck_t)
    ref = run_cli("jax", args + ["--max-iters", "8", "--checkpoint", ck_j],
                  tmp_path, capsys, "jax")
    port = run_cli("port", args + ["--max-iters", "8", "--checkpoint", ck_t],
                   tmp_path, capsys, "port")
    assert port.lines[4] == f"Resuming from {ck_t} (iteration 3)"
    assert port.rows[0][0] == 4
    port.lines[4] = port.lines[4].replace(ck_t, ck_j)
    assert_same(port, ref, "resume from a JAX checkpoint")


#: --precision f32 and mixed against JAX's: relative tolerances of the
#: pre statistics, the start energy, the first lambda and the post true
#: objective. A float32 state rounds R X + T, which cancels for far points,
#: so each residual moves by up to ~1e-4 px: the statistics and the start
#: energy of either package lie up to ~1e-5 from the float64 values (JAX's
#: and the port's differ by 2.6e-6 and 1.4e-5 on the tiny file, 4.3e-5 and
#: 9.7e-6 on p16), and the first lambda, 1e-12 of the float32 Jacobian's
#: largest squared column norm, up to ~1e-3 (3.8e-4 tiny, 9.2e-4 p16).
#: mixed keeps a float64 state: its statistics print identically, the
#: df32 start energy and first lambda differ by 4.8e-7 and 2.1e-5 (tiny),
#: 1.4e-7 and 4.6e-6 (p16). The rows after the first trial are not held:
#: at the first lambda (~1e-4) the float32 reduced camera system is
#: rounding noise in its weakest direction (Jacobi-scaled smallest
#: eigenvalue 9.5e-10 in float64, -1.1e-7 in JAX's float32 S and -2.1e-7 in
#: the port's), both packages' Cholesky factorizations break down, and the
#: refined QR fallback lands 0.016 (JAX) and 441 (port) from its own exact
#: solve on the tiny file, so each package accepts or rejects that trial by
#: its own rounding (test_torch_schur.py::test_float32_step_as_accurate_as_jax
#: holds the step's error over seeds). After 12 iterations both sit on the
#: float32 plateau: the post objectives differ by 4.7e-4 (f32) and 2.0e-4
#: (mixed), and lie within 2.6e-4 of the float64 run's.
PRECISION_RTOL = {"f32": dict(stats=1e-4, energy=1e-4, lam=2e-3, post=1e-3),
                  "mixed": dict(stats=0.0, energy=1e-6, lam=1e-4, post=1e-3)}
NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")


def _first_lambda(record):
    """The lambda the first trial ran at: a Rejected record prints it, an
    Accepted one prints it times the Nielsen factor of its rho."""
    if record["status"] == "Rejected":
        return record["lambda"]
    t = 2.0 * record["rho"] - 1.0
    return record["lambda"] / max(1.0 / 3.0, 1.0 - t * t * t)


def assert_precision_start(port: Run, ref: Run, precision: str, label: str):
    """Return codes, header, the pre statistics, the start energy and the
    first lambda of a --precision run against JAX's (PRECISION_RTOL)."""
    tol = PRECISION_RTOL[precision]
    assert port.rc == ref.rc == cli.RETURN_SUCCESS
    assert port.lines[0] == ref.lines[0]
    p_stats, r_stats = ([NUMBER.findall(ln.split(": ", 1)[1]) for ln in run.lines[1:4]]
                        for run in (port, ref))
    gap_stats = 0.0
    for p_nums, r_nums in zip(p_stats, r_stats):
        assert p_nums[1:] == r_nums[1:]  # the inlier counts
        gap_stats = max(gap_stats, _rel(float(p_nums[0]), float(r_nums[0])))
    gap_e = _rel(port.records[0]["f"], ref.records[0]["f"])
    gap_lam = _rel(_first_lambda(port.records[0]), _first_lambda(ref.records[0]))
    print(f"gap CLI {label} {precision}: pre statistics {gap_stats:.3g}, start "
          f"energy {gap_e:.3g}, first lambda {gap_lam:.3g} (tolerances "
          f"{tol['stats']:g}, {tol['energy']:g}, {tol['lam']:g})")
    assert gap_stats <= tol["stats"]
    assert gap_e <= tol["energy"] and gap_lam <= tol["lam"]


@pytest.mark.parametrize("precision", ["mixed", "f32"])
def test_precision_descends(tiny, tmp_path, capsys, precision):
    """--precision mixed and f32 against JAX's on the tiny file: the start
    (assert_precision_start), descent in both, and the post true objective
    after 12 iterations within PRECISION_RTOL of JAX's and of the port's
    float64 run. The f32 run's checkpoint holds float32."""
    ck = str(tmp_path / "ck.npz")
    args = [tiny, "--precision", precision, "--max-iters", "12"] + TAU
    ref = run_cli("jax", args, tmp_path, capsys, "jax")
    port = run_cli("port", args + ["--checkpoint", ck, "--checkpoint-every", "1"],
                   tmp_path, capsys, "port")
    f64 = run_cli("port", [tiny, "--max-iters", "12"] + TAU, tmp_path, capsys,
                  "f64")
    assert_precision_start(port, ref, precision, "tiny")
    pre, post = port.objective(0), port.objective(-1)
    gap, gap64 = _rel(post, ref.objective(-1)), _rel(post, f64.objective(-1))
    print(f"gap CLI precision {precision}: port {pre:.6g} -> {post:.6g}, JAX "
          f"{ref.objective(0):.6g} -> {ref.objective(-1):.6g}, relative gap of "
          f"the post objective {gap:.3g}, to the float64 run's {gap64:.3g}")
    assert post < pre and ref.objective(-1) < ref.objective(0)
    assert gap <= PRECISION_RTOL[precision]["post"]
    assert gap64 <= PRECISION_RTOL[precision]["post"]
    want = np.float32 if precision == "f32" else np.float64
    with np.load(ck) as d:
        assert all(d[f"state.{k}"].dtype == want
                   for k in ("K", "R", "T", "k1", "k2", "points"))


@pytest.mark.parametrize("precision", ["mixed", "f32"])
def test_precision_start_p16(tmp_path, capsys, precision):
    """The start of a --precision run on p16 against JAX's: statistics,
    start energy and first lambda (PRECISION_RTOL)."""
    args = [P16, "--precision", precision, "--max-iters", "1"]
    ref = run_cli("jax", args, tmp_path, capsys, "jax")
    port = run_cli("port", args, tmp_path, capsys, "port")
    assert_precision_start(port, ref, precision, "p16")
    print(f"gap CLI p16 {precision} after one iteration: post objective "
          f"{_rel(port.objective(-1), ref.objective(-1)):.3g}")
    assert port.objective(-1) < port.objective(0)


def test_f32_state_stays_float32():
    """A float32 problem on the float64 drive keeps a float32 state, every
    mode."""
    prob = synthetic.make_synthetic_problem(n_cameras=5, n_points=30, seed=2,
                                            dtype=torch.float32, device="cpu")
    for mode in SOLVERS:
        res = lm.minimize(prob, mode=mode, config=lm.LMConfig(max_iter=3),
                          device="cpu")
        dtypes = {getattr(res.state, k).dtype
                  for k in ("K", "R", "T", "k1", "k2", "points")}
        assert dtypes == {torch.float32}, (mode, dtypes)
        assert np.isfinite(res.energy)


#: The two-phase runs' final energies, port against JAX: the fast phases
#: differ by the packages' df32 rounding (~1e-8 of scale) and stop at the
#: 1e-6 flatline tolerance, so the endpoints agree to that tolerance's
#: order, not to float64's.
POLISH_RTOL = 1e-4


def test_polish(tiny, tmp_path, capsys):
    args = [tiny, "--precision", "mixed", "--polish", "3", "--max-iters",
            "20"] + TAU
    ref = run_cli("jax", args, tmp_path, capsys, "jax")
    port = run_cli("port", args, tmp_path, capsys, "port")
    assert port.rc == ref.rc == cli.RETURN_SUCCESS
    phases = [r["phase"] for r in port.records]
    assert phases[0] == "fast" and phases[-1] == "polish"
    assert phases == sorted(phases)  # "fast" records, then "polish" records
    polish_iters = {r["iter"] for r in port.records if r["phase"] == "polish"}
    assert polish_iters and max(polish_iters) <= 3
    gap = _rel(port.objective(-1), ref.objective(-1))
    e_port = [r["f"] for r in port.records if r["phase"] == "polish"][-1]
    e_jax = [r["f"] for r in ref.records if r["phase"] == "polish"][-1]
    print(f"gap CLI polish: post objective {gap:.3g}, last polish f "
          f"{_rel(e_port, e_jax):.3g} (tolerance {POLISH_RTOL:g})")
    assert gap <= POLISH_RTOL and _rel(e_port, e_jax) <= POLISH_RTOL

    # The result sums the two phases' counts.
    prob = synthetic.make_synthetic_problem(n_cameras=6, n_points=40,
                                            obs_per_point=4, seed=1,
                                            inlier_threshold=2.0, device="cpu")
    cfg = lm.LMConfig(max_iter=20, matmul_dtype="float32", geometry="df32",
                      polish_iters=3)
    both = lm.minimize(prob, config=cfg, device="cpu")
    fast = lm.minimize(prob, device="cpu", config=lm.LMConfig(
        max_iter=20, matmul_dtype="float32", geometry="df32", tol_fun=1e-6))
    polish = lm.minimize(prob, state=fast.state, device="cpu",
                         config=lm.LMConfig(max_iter=3))
    assert both.iterations == fast.iterations + polish.iterations
    assert both.fun_evals == fast.fun_evals + polish.fun_evals
    assert both.energy == polish.energy
    assert both.status == (fast.status if polish.status == lm.LMStatus.MaxItersReached
                           else polish.status)


def test_drive_jit_and_profile_and_debug_nans_accepted(tiny, tmp_path, capsys):
    """--drive jit runs the device-resident drive (on the CPU, its slot
    eagerly): its table is the host drive's row for row, f and lambda
    exactly, with JAX's convention for the rejected rows it synthesizes
    from each iteration's record (rho "-" where the host prints 0; JSONL
    rho null and synthesized true); Elapsed is not compared.
    --profile-dir writes a trace; --debug-nans changes nothing on a finite
    run."""
    args = [tiny, "--max-iters", "12", "--tol", "1e-30"] + TAU
    base = run_cli("port", args, tmp_path, capsys, "a")
    other = run_cli("port", args + ["--drive", "jit", "--debug-nans",
                                    "--profile-dir", str(tmp_path / "prof")],
                    tmp_path, capsys, "b")
    assert other.rc == cli.RETURN_SUCCESS
    assert other.lines == base.lines
    assert "Rejected" in [r[1] for r in base.rows]
    assert [(r[0], r[1], r[2], r[4]) for r in other.rows] == [
        (r[0], r[1], r[2], r[4]) for r in base.rows]
    assert [r[3] for r in other.rows] == [
        r[3] if r[1] == "Accepted" else None for r in base.rows]
    assert [(r["iter"], r["status"], r["f"], r["lambda"]) for r in other.records
            if "iter" in r] == [(r["iter"], r["status"], r["f"], r["lambda"])
                                for r in base.records]
    assert [(r["rho"] is None, r["synthesized"]) for r in other.records
            if "iter" in r] == [(r["status"] == "Rejected",) * 2
                                for r in base.records]
    assert "compile_s" in other.records[0]
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_debug_nans_raises():
    """A NaN point: the loop rejects every trial and stops with
    ExceededLambdaMax, or with debug_nans raises at the first read."""
    prob = synthetic.make_synthetic_problem(seed=1, device="cpu")
    prob.state.points[0, 0] = float("nan")
    res = lm.minimize(prob, config=lm.LMConfig(max_iter=3), device="cpu")
    assert res.status == lm.LMStatus.ExceededLambdaMax
    with pytest.raises(FloatingPointError, match="LM iteration 1"):
        lm.minimize(prob, config=lm.LMConfig(max_iter=3, debug_nans=True),
                    device="cpu")


@pytest.mark.parametrize("case,rc", [
    ("no arguments", cli.RETURN_WRONG_INPUT_PARAMS),
    ("missing file", cli.RETURN_WRONG_INPUT_FILE),
    ("shards", cli.RETURN_WRONG_INPUT_PARAMS),
    ("no device", cli.RETURN_WRONG_INPUT_PARAMS),
    ("bogus solver", cli.RETURN_WRONG_INPUT_PARAMS),
])
def test_error_paths(tiny, tmp_path, capsys, case, rc):
    log = ["--log-file", str(tmp_path / "run.log")]
    argv = {
        "no arguments": [],
        "missing file": [str(tmp_path / "nope.txt"), "--device", "cpu"] + log,
        "shards": [tiny, "--shards", "-2", "--device", "cpu"] + log,
        "no device": [tiny] + log,
        "bogus solver": [tiny, "--solver", "bogus", "--device", "cpu"] + log,
    }[case]
    if case == "no device" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(argv) == rc
    captured = capsys.readouterr()
    assert "N(cameras)" not in captured.out  # nothing ran, on no device
    if case == "shards":
        assert "--shards -2" in captured.err
    if case == "no device":
        assert "--device cpu" in captured.err


def test_module_entry_point(tmp_path):
    """``python -m bundleadjustment_benchmarks_tpu_torch.cli`` with no
    arguments prints the usage and exits 1."""
    proc = subprocess.run(
        [sys.executable, "-m", "bundleadjustment_benchmarks_tpu_torch.cli"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == cli.RETURN_WRONG_INPUT_PARAMS
    assert "usage:" in proc.stderr

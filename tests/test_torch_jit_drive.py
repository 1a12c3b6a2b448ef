"""The port's device-resident LM drive (``LMConfig(drive="jit")``) on the
CPU, against the JAX package's jit drive and against the port's host drive.

On the CPU the drive runs the chunk that a CUDA graph captures on the card
(``lm.DeviceLoop``), eagerly: its device conditionals and its loop of
trials read their predicates.
The same inputs, made with numpy from a seed, go to both packages.

Tolerances:
- f64, against JAX's jit drive: the same iterations, function evaluations
  and status, energies within 1e-9 relative (the bound of
  test_torch_lm.py::test_lm_f64_matches_jax; measured <= 2e-12).
- df32, against JAX's jit drive: as test_lm_df32_converges states, both
  below half the start energy. The packages' df32 rows differ by ~1e-8 of
  scale, and the runs part by rounding within a few iterations.
- Against the port's host drive: the same counts and status, energies
  within 1e-10 relative (JAX's test_lm.py::test_lm_jit_matches_host). The
  two drives do the same arithmetic in the same order, so the measured gap
  is 0 (printed with ``pytest -rP``).
- The chunked table and records against JAX's chunked_loop: the CLI
  tolerances of test_torch_cli.py (f 1e-7, lambda 1e-8, rho 1e-7 on
  resolved steps), rows and synthesized-row marks exactly.
"""

import dataclasses
import json
import math
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu import cli as jcli
from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.ops import projection as jproj
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import cli, convert
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph, jacobian
from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint
from test_torch_cli import (KEPT, RHO_RESOLVED, RTOL_F, RTOL_LAMBDA, RTOL_RHO,
                            TAU, write_synthetic_bal)

MODES = ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")
P16 = str(Path(__file__).resolve().parents[1] / "data" / "problem-16-22106-pre.txt.gz")
ROW = re.compile(r"^\s*(\d+)\s+(Accepted|Rejected)\s+(\S+)\s+(\S+)\s+(\S+)\s+\S+s$")


def _pair(seed, **kw):
    jp = make_synthetic_problem(dtype=jnp.float64, seed=seed, **kw)
    return jp, convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")


def _counts(res):
    return res.iterations, res.fun_evals, int(res.status)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _drives(tp, mode, state=None, **kw):
    """(jit, host) results of the port on the same problem and config."""
    return tuple(lm.minimize(tp, mode=mode, state=state, device="cpu",
                             config=lm.LMConfig(drive=d, **kw))
                 for d in ("jit", "host"))


def _hold_to_host(jit, host, label):
    gap = _rel(jit.energy, host.energy)
    print(f"gap jit-host {label}: energy {gap:.3g}, lambda "
          f"{_rel(jit.lam, host.lam) if math.isfinite(host.lam) else 0.0:.3g}")
    assert _counts(jit) == _counts(host)
    assert gap <= 1e-10


@pytest.mark.parametrize("mode", MODES)
def test_jit_f64_matches_jax_and_host(mode):
    jp, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                   inlier_threshold=2.0)
    res_j = jlm.minimize(jp, mode=mode, config=jlm.LMConfig(drive="jit",
                                                            max_iter=10))
    jit, host = _drives(tp, mode, max_iter=10)
    gap = _rel(jit.energy, res_j.energy)
    print(f"gap jit f64 {mode} vs JAX jit: counts {_counts(jit)}, energy {gap:.3g}")
    assert res_j.status == jlm.LMStatus.Success
    assert _counts(jit) == _counts(res_j)
    assert gap <= 1e-9
    _hold_to_host(jit, host, f"f64 {mode}")


@pytest.mark.parametrize("mode", MODES)
def test_jit_df32_matches_jax_and_host(mode):
    jp, tp = _pair(3, n_cameras=5, n_points=37, obs_per_point=5,
                   inlier_threshold=2.0)
    e0 = float(jproj.energy(jp.state, jp.obs, jp.tau2))
    kw = dict(max_iter=8, matmul_dtype="float32", geometry="df32")
    res_j = jlm.minimize(jp, mode=mode, config=jlm.LMConfig(drive="jit", **kw))
    jit, host = _drives(tp, mode, **kw)
    print(f"df32 {mode}: port jit {jit.energy:.6g}, JAX jit {res_j.energy:.6g}, "
          f"start {e0:.6g}")
    assert jit.energy < 0.5 * e0 and res_j.energy < 0.5 * e0
    _hold_to_host(jit, host, f"df32 {mode}")


def _nan_point(jp, tp):
    pts = np.asarray(jp.state.points).copy()
    pts[0, 0] = np.nan
    js = dataclasses.replace(jp.state, points=jnp.asarray(pts))
    ts = dataclasses.replace(tp.state, points=torch.from_numpy(pts))
    return js, ts


#: (label, problem keywords, LMConfig keywords): each limit and stop of the
#: loop. "lambda_max": a start perturbed by 1 px-scale noise whose first
#: step overshoots, so the first trial is rejected and lambda_max = 1e-30
#: stops the run there, before rounding can part the packages.
LIMITS = (
    ("max_iter", {}, dict(max_iter=3)),
    ("max_fun_ev", {}, dict(max_fun_ev=5)),
    ("lambda_max", dict(noise=1.0, seed=1), dict(lambda_max=1e-30, max_iter=20)),
    ("nan_point", {}, dict(max_iter=3)),
    ("keep_final_step", {}, dict(discard_final_step=False, max_iter=10)),
    ("max_iter_0", {}, dict(max_iter=0)),
)


@pytest.mark.parametrize("label,pkw,kw", LIMITS, ids=[c[0] for c in LIMITS])
def test_jit_limits_and_bookkeeping(label, pkw, kw):
    pkw = dict(dict(seed=0, n_cameras=6, n_points=40, obs_per_point=4,
                    inlier_threshold=2.0), **pkw)
    jp, tp = _pair(pkw.pop("seed"), **pkw)
    js = ts = None
    if label == "nan_point":
        js, ts = _nan_point(jp, tp)
    res_j = jlm.minimize(jp, state=js, config=jlm.LMConfig(drive="jit", **kw))
    jit, host = _drives(tp, "cholesky", state=ts, **kw)
    print(f"{label}: JAX {_counts(res_j)} {res_j.energy!r}, port jit "
          f"{_counts(jit)} {jit.energy!r}")
    assert _counts(jit) == _counts(res_j)
    expect = {"max_iter": lm.LMStatus.MaxItersReached,
              "max_iter_0": lm.LMStatus.MaxItersReached,
              "max_fun_ev": lm.LMStatus.TooManyFunctionEvaluation,
              "lambda_max": lm.LMStatus.ExceededLambdaMax,
              "nan_point": lm.LMStatus.ExceededLambdaMax,
              "keep_final_step": lm.LMStatus.Success}[label]
    assert jit.status == expect
    if math.isfinite(res_j.energy):
        assert _rel(jit.energy, res_j.energy) <= 1e-9
        assert _rel(jit.energy, host.energy) <= 1e-10
    else:  # nan (the NaN point) or inf (no iteration ran)
        assert repr(jit.energy) == repr(res_j.energy) == repr(host.energy)
    assert _counts(jit) == _counts(host)
    if label == "keep_final_step":
        # The final accepted step is kept: the state moved past the
        # discarding run's.
        disc = lm.minimize(tp, device="cpu", config=lm.LMConfig(
            drive="jit", max_iter=10))
        assert not torch.equal(disc.state.points, jit.state.points)


def test_jit_debug_nans_and_resume(tmp_path):
    """debug_nans raises at the chunk read that holds the first non-finite
    trial and names its iteration; a run resumed from a checkpoint of the
    jit drive ends as JAX's jit drive resumed from the same checkpoint."""
    jp, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                   inlier_threshold=2.0)
    _, ts = _nan_point(jp, tp)
    with pytest.raises(FloatingPointError, match="LM iteration 1"):
        lm.minimize(tp, state=ts, device="cpu", config=lm.LMConfig(
            drive="jit", max_iter=3, debug_nans=True))

    ck = str(tmp_path / "ck.npz")
    lm.minimize(tp, device="cpu", checkpoint_path=ck, checkpoint_every=2,
                config=lm.LMConfig(drive="jit", max_iter=3, chunk_size=2))
    state, meta = checkpoint.load_checkpoint(ck, device="cpu")
    # Chunks of 2: the checkpoint falls at the first chunk end at or past 2.
    assert meta["iteration"] == 2
    res_t = lm.minimize(tp, state=state, resume=meta, device="cpu",
                        config=lm.LMConfig(drive="jit", max_iter=10))
    js = convert.state_to_numpy(state)
    jstate = dataclasses.replace(jp.state, **{k: jnp.asarray(v)
                                             for k, v in js.items()})
    res_j = jlm.minimize(jp, state=jstate, resume=meta,
                         config=jlm.LMConfig(drive="jit", max_iter=10))
    print(f"resume: port {_counts(res_t)} {res_t.energy!r}, JAX "
          f"{_counts(res_j)} {res_j.energy!r}")
    assert _counts(res_t) == _counts(res_j)
    assert _rel(res_t.energy, res_j.energy) <= 1e-9
    host = lm.minimize(tp, state=state, resume=meta, device="cpu",
                       config=lm.LMConfig(max_iter=10))
    assert _counts(host) == _counts(res_t) and host.energy == res_t.energy


# -- the chunked drive through the command line --------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_synthetic_bal(str(tmp_path_factory.mktemp("bal") / "tiny.txt"))


class JitRun:
    """One ``--drive jit`` CLI run: return code, kept lines, table rows
    (iter, status, f, rho or None for "-", lambda) and JSONL records."""

    def __init__(self, which, args, tmp_path, capsys, tag):
        capsys.readouterr()
        metrics = str(tmp_path / f"{tag}.jsonl")
        extra = ["--drive", "jit", "--metrics", metrics,
                 "--log-file", str(tmp_path / f"{tag}.log")]
        if which == "jax":
            try:
                self.rc = jcli.main(args + extra)
            finally:
                jax.config.update("jax_enable_x64", True)
        else:
            self.rc = cli.main(args + extra + ["--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        self.lines = [ln for ln in lines if ln.startswith(KEPT)]
        self.rows = [(int(m[1]), m[2], float(m[3]),
                      None if m[4] == "-" else float(m[4]), float(m[5]))
                     for m in map(ROW.match, lines) if m]
        self.jit_header = [ln for ln in lines if ln.startswith("(chunked jit")]
        with open(metrics) as f:
            self.records = [json.loads(ln) for ln in f]


def _hold_rows(port: JitRun, ref: JitRun, label: str) -> None:
    assert port.rc == ref.rc == cli.RETURN_SUCCESS
    assert len(port.jit_header) == len(ref.jit_header) == 1
    assert [r[:2] for r in port.rows] == [r[:2] for r in ref.rows]
    assert [r[3] is None for r in port.rows] == [r[3] is None for r in ref.rows]
    gaps = {"f": 0.0, "lambda": 0.0, "rho": 0.0}
    for i, (p, r) in enumerate(zip(port.rows, ref.rows)):
        gaps["f"] = max(gaps["f"], _rel(p[2], r[2]))
        gaps["lambda"] = max(gaps["lambda"], _rel(p[4], r[4]))
        nxt = ref.rows[i + 1][2] if i + 1 < len(ref.rows) else r[2]
        if r[3] is not None and nxt <= (1.0 - RHO_RESOLVED) * r[2]:
            gaps["rho"] = max(gaps["rho"], _rel(p[3], r[3]))
    print(f"gap chunked CLI {label}: " + ", ".join(
        f"{k} {v:.3g}" for k, v in gaps.items()))
    assert gaps["f"] <= RTOL_F and gaps["lambda"] <= RTOL_LAMBDA
    assert gaps["rho"] <= RTOL_RHO
    assert "compile_s" in port.records[0] and "compile_s" in ref.records[0]
    key = ("iter", "status", "synthesized", "elapsed_kind")
    assert [[r.get(k) for k in key] + [r["rho"] is None]
            for r in port.records[1:]] == [
        [r.get(k) for k in key] + [r["rho"] is None] for r in ref.records[1:]]


def test_chunked_cli_matches_jax(tiny, tmp_path, capsys):
    """JAX's test_cli_jit_verbose_checkpoint_resume, both packages: the
    table row for row, the JSONL records with their synthesized rows, the
    checkpoint (the first chunk end at or past iteration 3), and each
    package resumed from the other's checkpoint."""
    ck_j, ck_t = str(tmp_path / "j.ckpt.npz"), str(tmp_path / "t.ckpt.npz")
    args = [tiny, "--max-iters", "6", "--checkpoint-every", "3"] + TAU
    ref = JitRun("jax", args + ["--checkpoint", ck_j], tmp_path, capsys, "jax")
    port = JitRun("port", args + ["--checkpoint", ck_t], tmp_path, capsys, "port")
    _hold_rows(port, ref, "first run")
    assert port.lines == ref.lines
    (_, mt), (_, mj) = (checkpoint.load_checkpoint(c, device="cpu")
                        for c in (ck_t, ck_j))
    assert (mt["iteration"], mt["fun_evals"]) == (mj["iteration"], mj["fun_evals"])
    assert _rel(mt["lam"], mj["lam"]) <= RTOL_LAMBDA
    # Cross: the port resumes from JAX's checkpoint, JAX from the port's.
    ck_jt, ck_tj = str(tmp_path / "jt.ckpt.npz"), str(tmp_path / "tj.ckpt.npz")
    shutil.copy(ck_j, ck_jt)
    shutil.copy(ck_t, ck_tj)
    args = [tiny, "--max-iters", "9", "--checkpoint-every", "3"] + TAU
    port2 = JitRun("port", args + ["--checkpoint", ck_jt], tmp_path, capsys, "port2")
    ref2 = JitRun("jax", args + ["--checkpoint", ck_tj], tmp_path, capsys, "jax2")
    assert [ln for ln in port2.lines if ln.startswith("Resuming from")] == [
        f"Resuming from {ck_jt} (iteration {mj['iteration']})"]
    assert port2.rows[0][0] == ref2.rows[0][0] == mj["iteration"] + 1
    port2.lines = [ln.replace(ck_jt, ck_tj) for ln in port2.lines]
    _hold_rows(port2, ref2, "resumed across packages")
    assert port2.lines == ref2.lines


# -- the pieces ------------------------------------------------------------------


def _context(tp, mode, df32):
    if df32:
        from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
        from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain

        blocks, _ = cuda_chain.fused_blocks_energy_plain(
            pm.to_fast(tp.state), tp.obs, tp.tau2)
        return schur.build_context(blocks, tp, mode, mm_dtype=torch.float32), \
            torch.float32
    blocks = jacobian.residuals_and_jacobian(tp.state, tp.obs, tp.tau2)
    return schur.build_context(blocks, tp, mode), None


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "no_pairs"])
@pytest.mark.parametrize("df32", [False, True], ids=["f64", "df32"])
def test_lambda_tensor_bit_for_bit(df32, pairs):
    """solve_damped, refine_step and gradient_dot at a 0-dim float64 tensor
    lambda equal the float path bit for bit, for every mode, with and
    without pair tables (qrkit "pair" and "rows")."""
    _, tp = _pair(1, n_cameras=5, n_points=30, obs_per_point=4,
                  inlier_threshold=2.0)
    if not pairs:
        tp = dataclasses.replace(tp, pairs=None)
    lam = 3.0517578125e-05 if df32 else 2.2e-4  # a float32 value on df32
    for mode in MODES:
        ctx, mm = _context(tp, mode, df32)
        lam_t = torch.tensor(lam, dtype=torch.float64)
        a = schur.solve_damped(ctx, lam, tp, mode, mm_dtype=mm)
        b = schur.solve_damped(ctx, lam_t, tp, mode, mm_dtype=mm)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), mode
        assert torch.equal(schur.gradient_dot(ctx, *a, lam),
                           schur.gradient_dot(ctx, *b, lam_t)), mode
        if schur.MODE_STRATEGY[mode][1] == "chol":
            ra = schur.refine_step(ctx, lam, tp, mode, *a, mm_dtype=mm)
            rb = schur.refine_step(ctx, lam_t, tp, mode, *b, mm_dtype=mm)
            assert all(torch.equal(x, y) for x, y in zip(ra, rb)), mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_breakdown_branch_is_a_device_predicate(dtype):
    """The Cholesky breakdown test decides on the predicate, in either
    dtype: an indefinite S takes the fallback (equal to it computed
    eagerly; float32 the refined LU, float64 the R-only QR of [D S D | D b]) and
    counts it, a positive definite one the Cholesky solve (refined twice
    in float32, once in float64) and counts nothing."""
    rng = np.random.default_rng(0)
    n = 18
    A = rng.normal(size=(n, n))
    b = torch.from_numpy(rng.normal(size=n)).to(dtype)
    f64 = torch.float64
    for name, S64 in (("indefinite", A + A.T), ("definite", A @ A.T + n * np.eye(n))):
        S = torch.from_numpy(S64).to(dtype)
        cuda_graph.zero_marks("cpu")
        x = schur._camera_solve_chol(S, b)
        marks = cuda_graph.unpack(cuda_graph.readable("cpu").tolist())
        # The two branches, eagerly.
        S64t, b64 = S.to(f64), b.to(f64)
        d = torch.diagonal(S64t)
        dinv = torch.where(d > 0, torch.rsqrt(d.abs() + torch.finfo(f64).tiny),
                           torch.ones_like(d))
        Ss = (S64t * dinv[:, None] * dinv[None, :]).to(dtype)
        L, info = torch.linalg.cholesky_ex(Ss)
        broke = bool(info != 0) or not bool(torch.isfinite(L).all())
        assert broke == (name == "indefinite")
        assert marks["camera_fallback"] == int(broke), name
        assert marks["span_counts"]["camera_solve"] == 1
        if dtype == f64:
            bs = (b64 * dinv)[:, None]
            if broke:
                R = torch.linalg.qr(torch.cat([Ss, bs], dim=1), mode="r")[1]
                ref = torch.linalg.solve_triangular(R[:, :n], R[:, n:], upper=True)
            else:
                # One refinement pass on the scaled system, as the solve
                # holds it: the left part of [D S D | D b].
                Ss = torch.cat([Ss, bs], dim=1)[:, :n]
                ref = torch.cholesky_solve(bs, L)
                ref = ref + torch.cholesky_solve(bs - Ss @ ref, L)
            assert torch.equal(x, ref[:, 0] * dinv), name
            continue
        if broke:
            LU, piv, _ = torch.linalg.lu_factor_ex(Ss)
            solve = lambda r: torch.linalg.lu_solve(  # noqa: E731
                LU, piv, r.to(torch.float32)[:, None])[:, 0].to(f64)
        else:
            solve = lambda r: torch.cholesky_solve(  # noqa: E731
                r.to(torch.float32)[:, None], L)[:, 0].to(f64)
        ref = solve(b64 * dinv) * dinv
        for _ in range(2):
            ref = ref + solve((b64 - S64t @ ref) * dinv) * dinv
        assert torch.equal(x, ref.to(torch.float32)), name


def test_singular_camera_system_is_a_non_finite_trial(monkeypatch):
    """An exactly singular float32 reduced system (a camera whose row and
    column of S are zero) takes the fallback, whose LU meets a zero pivot:
    x comes out non-finite, as the QR's singular R made it. Both drives
    treat that trial as any non-finite trial: each run equals, bit for bit,
    the one whose first camera solve returns NaN outright, and debug_nans
    raises at the jit drive's read of iteration 1."""
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    kw = dict(max_iter=4, matmul_dtype="float32", geometry="df32")
    assemble, solve = schur.assemble_reduced, schur._camera_solve_chol

    def on_first_call(fn):
        calls = [0]

        def wrapped(*args):
            calls[0] += 1
            return fn(calls[0] == 1, *args)
        return wrapped

    def singular(first, *args):
        S, b = assemble(*args)
        if first:
            S = S.clone()
            S[0, :] = 0
            S[:, 0] = 0
        return S, b

    def nan_solve(first, S, b):
        x = solve(S, b)
        return torch.full_like(x, math.nan) if first else x

    xs = []

    def watched(S, b):
        xs.append(solve(S, b))
        return xs[-1]

    for drive in ("jit", "host"):
        cfg = lm.LMConfig(drive=drive, **kw)
        xs.clear()
        with monkeypatch.context() as m:
            m.setattr(schur, "assemble_reduced", on_first_call(singular))
            m.setattr(schur, "_camera_solve_chol", watched)
            got = lm.minimize(tp, "cholesky", cfg, device="cpu")
        assert xs[0].dtype == torch.float32
        assert not bool(torch.isfinite(xs[0]).any()), drive
        assert all(bool(torch.isfinite(x).all()) for x in xs[1:]), drive
        with monkeypatch.context() as m:
            m.setattr(schur, "_camera_solve_chol", on_first_call(nan_solve))
            ref = lm.minimize(tp, "cholesky", cfg, device="cpu")
        print(f"singular camera system, {drive}: {_counts(got)} {got.energy!r}; "
              f"NaN solve {_counts(ref)} {ref.energy!r}")
        assert _counts(got) == _counts(ref), drive
        assert math.isfinite(got.energy) and got.energy == ref.energy, drive
        assert got.lam == ref.lam, drive
        assert torch.equal(got.state.points, ref.state.points), drive
    with monkeypatch.context() as m:
        m.setattr(schur, "assemble_reduced", on_first_call(singular))
        with pytest.raises(FloatingPointError, match="LM iteration 1"):
            lm.minimize(tp, "cholesky", lm.LMConfig(
                drive="jit", debug_nans=True, **kw), device="cpu")


def test_growth_table_and_reads():
    """The device's lambda growth table is the host drive's recurrence
    (saturating at inf), and a ``chunked`` drive reads the host once per
    chunk."""
    table = lm.growth_table(2.0)
    inc, ref = 2.0, []
    for _ in range(12):
        ref.append(inc)
        inc = inc ** 1.5
    assert table[:12] == ref and table[-1] == math.inf
    assert lm.growth_table(1.0) == [1.0] * len(table)
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    cfg = lm.LMConfig(drive="jit", max_iter=3, chunk_size=2, chunked=True)
    prepare, trial, to_loop, _ = lm.step_functions(tp, "cholesky", cfg, "cpu")
    loop = lm.DeviceLoop(to_loop(tp.state), prepare, trial, cfg,
                         torch.device("cpu"))
    _, status, it, fun_evals, _, _ = loop.run(to_loop(tp.state))
    # 3 iterations of one accepted trial each in chunks of 2: one read
    # per chunk, the second finding max_iter; the counts JAX keeps.
    assert (status, it, fun_evals) == (lm.LMStatus.MaxItersReached, 4, 6)
    assert loop.reads == 2
    # A loop runs with the limits of the config it is given.
    _, status, it, fun_evals, _, _ = loop.run(
        to_loop(tp.state), config=dataclasses.replace(cfg, max_iter=1))
    assert (status, it, fun_evals) == (lm.LMStatus.MaxItersReached, 2, 2)


@pytest.mark.parametrize("chunk_size", [2, 4, 16])
def test_one_read_per_chunk_with_rejections(chunk_size):
    """A chunked run whose iterations reject trials (to the lambda-max
    stop) still reads the host once per chunk, and counts every trial on
    the device: the host drive's path, one read per chunk."""
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    jit, host = _drives(tp, "cholesky", max_iter=30, tol_fun=1e-30,
                        chunk_size=chunk_size, chunked=True)
    assert _counts(jit) == _counts(host) and jit.energy == host.energy
    assert jit.status == lm.LMStatus.ExceededLambdaMax
    assert jit.fun_evals - jit.iterations > jit.iterations  # rejections
    chunks = -(-jit.iterations // chunk_size)
    print(f"chunk {chunk_size}: {jit.iterations} iterations, "
          f"{jit.fun_evals} evaluations, {lm.LAST_JIT_RUN}")
    assert lm.LAST_JIT_RUN["reads"] == lm.LAST_JIT_RUN["replays"] == chunks
    assert lm.LAST_JIT_RUN["slots"] == jit.fun_evals - jit.iterations


@pytest.mark.parametrize("chunked", [False, True], ids=["one-dispatch", "chunked"])
def test_chunk_cap_raises_where_lambda_cannot_grow(chunked):
    """With lambda_increase_base 1 a rejected trial never ends its
    iteration (the host drive loops forever): on either route the
    iteration stops at its cap of 129 trials (as many as one can take
    where lambda grows) and the run raises at its read, whatever
    ``max_iter`` is."""
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    cfg = lm.LMConfig(drive="jit", max_iter=1_000_000, chunk_size=2,
                      tol_fun=1e-30, lambda_increase_base=1.0, chunked=chunked)
    with pytest.raises(RuntimeError, match="ran 129 trials without ending"):
        lm.minimize(tp, device="cpu", config=cfg)


def test_device_while_and_if_on_cpu():
    """On the CPU, device_while reads its condition before each pass and
    device_if its predicate (the same code captures loop and conditional
    nodes on the card)."""
    x = torch.zeros((), dtype=torch.float64)
    odd = torch.zeros((), dtype=torch.float64)

    def body():
        x.add_(1.0)
        cuda_graph.device_if(torch.remainder(x, 2.0) == 1.0,
                             lambda: odd.add_(1.0))

    cuda_graph.device_while(lambda: x < 5.0, body)
    assert (x.item(), odd.item()) == (5.0, 3.0)
    cuda_graph.device_while(lambda: x < 5.0, body)
    assert (x.item(), odd.item()) == (5.0, 3.0)


def test_graph_key_is_the_problem_object():
    """The capture cache tells apart two problems that share their
    observation tensors (a replaced inlier threshold or pair table), and
    ignores the limits and ``chunked``, which the graph reads from the
    device (one capture serves both routes)."""
    _, tp = _pair(0)
    cfg = lm.LMConfig(drive="jit")
    x0 = lm.step_functions(tp, "cholesky", cfg, "cpu")[2](tp.state)
    key = lm._graph_key(tp, "cholesky", cfg, x0, "cuda:0")
    other = dataclasses.replace(tp, inlier_threshold=tp.inlier_threshold * 2)
    assert lm._graph_key(other, "cholesky", cfg, x0, "cuda:0") != key
    assert lm._graph_key(tp, "cholesky", dataclasses.replace(
        cfg, max_iter=3, max_fun_ev=7, tol_fun=1e-3, chunked=True), x0,
        "cuda:0") == key


def test_graph_cache_holds_one_problem_per_device_and_group(monkeypatch):
    """A capture for another problem frees the cached captures of every
    other problem on its device and group, and keeps the same problem's
    other modes, other devices' and other groups' captures."""
    closed = []

    class Loop:
        def __init__(self, name):
            self.name = name

        def close(self):
            closed.append(self.name)

    a, b = object(), object()
    group = ("nccl", 0, 1, 7)
    cache = {("cuda:0", id(a), "cholesky", None): (a, Loop("a cholesky")),
             ("cuda:0", id(a), "qrkit", None): (a, Loop("a qrkit")),
             ("cuda:1", id(a), "cholesky", None): (a, Loop("a on cuda:1")),
             ("cuda:0", id(a), "cholesky", group): (a, Loop("a sharded")),
             ("cuda:0", id(b), "qrkit", None): (b, Loop("b qrkit"))}
    monkeypatch.setattr(lm, "_GRAPHS", cache)
    lm._free_other_problems(("cuda:0", id(b), "cholesky", None), b)
    assert sorted(closed) == ["a cholesky", "a qrkit"]
    assert sorted(loop.name for _, loop in cache.values()) == [
        "a on cuda:1", "a sharded", "b qrkit"]
    lm._free_other_problems(("cuda:0", id(b), "cholesky", group), b)
    assert closed[-1] == "a sharded" and len(cache) == 2
    lm.clear_graphs()
    assert cache == {}


def test_default_drive_is_jax_default():
    assert lm.LMConfig().drive == jlm.LMConfig().drive == "jit"


#: Measured gaps of the port's float64 p16 cholesky energies to JAX's, both
#: on the CPU, per iteration (either drive, in either package: each
#: package's two drives give the same energies): 2.1e-10, 1.1e-9, 1.0e-7,
#: 3.4e-9, 2.0e-7, 4.0e-7, then 3.8e-4 and 1.0e-3 where rho, and so lambda,
#: part (5.04e-5 against 2.89e-5 after iteration 8). The damped steps of the
#: two packages differ by ~1e-8 relative on p16's ill-conditioned reduced
#: system (test_torch_schur.py::test_solve_damped_as_accurate_as_jax), and
#: the energies follow. So the first iteration is held to 1e-9, iterations
#: 2-6 to 1e-6 (about 3x the largest gap there), and the run of 8 to the
#: same counts and status.
P16_FIRST_ITERATION_RTOL = 1e-9
P16_PREFIX_RTOL = 1e-6
P16_PREFIX = 6


def test_default_config_matches_jax_default_on_p16():
    """Each package's default config (max_iter 8) on p16 in float64,
    cholesky: the same iterations, evaluations and status, the first
    iteration's energy within P16_FIRST_ITERATION_RTOL and each of the next
    ones up to P16_PREFIX within P16_PREFIX_RTOL (JAX's energy after k
    iterations from its default run with max_iter k, whose limits are
    traced: one compile); the port's default run took the jit drive (one
    read for its one chunk), equals its explicit jit run bit for bit and its
    host run (gap 0.0)."""
    jp = jpm.load_bal_problem(P16)
    tp = pm.load_bal_problem(P16, device="cpu")
    res_j = jlm.minimize(jp, config=dataclasses.replace(jlm.LMConfig(),
                                                        max_iter=8))
    prefix_j = [float(jlm.minimize(jp, config=dataclasses.replace(
        jlm.LMConfig(), max_iter=k)).energy) for k in range(1, P16_PREFIX + 1)]
    lm.LAST_JIT_RUN.clear()
    trace = []
    res_t = lm.minimize(tp, config=dataclasses.replace(lm.LMConfig(), max_iter=8),
                        device="cpu", trace=trace)
    counted = dict(lm.LAST_JIT_RUN)
    jit, host = _drives(tp, "cholesky", max_iter=8)
    # The unobserved default run is JAX's one dispatch: one read.
    assert lm.LAST_JIT_RUN["reads"] == 1 and not lm.LAST_JIT_RUN["chunked"]
    assert [r["iter"] for r in trace[:P16_PREFIX]] == list(range(1, P16_PREFIX + 1))
    gaps = [_rel(r["energy"], e) for r, e in zip(trace, prefix_j)]
    print(f"gap default config p16 f64 cholesky vs JAX: counts {_counts(res_t)}, "
          f"iterations 1-{P16_PREFIX} {[f'{g:.3g}' for g in gaps]}, after 8 "
          f"{_rel(res_t.energy, float(res_j.energy)):.3g}; jit-host "
          f"{_rel(res_t.energy, host.energy):.3g}")
    assert _counts(res_t) == _counts(res_j) == (9, 16, int(lm.LMStatus.MaxItersReached))
    assert gaps[0] <= P16_FIRST_ITERATION_RTOL
    assert max(gaps[1:]) <= P16_PREFIX_RTOL
    assert counted["reads"] == 1 and counted["prepares"] == 8
    assert _counts(jit) == _counts(res_t) and jit.energy == res_t.energy
    assert torch.equal(jit.state.points, res_t.state.points)
    assert _counts(host) == _counts(res_t) and host.energy == res_t.energy


def _sharded_one_rank(rank, device, tp, cfg):
    sp = sharded.shard_problem(tp, 1, rank, device=device)
    return sharded.minimize_sharded(sp, "cholesky", cfg)


def test_jit_refusals(tiny, tmp_path, capsys):
    """What drive='jit' refuses, and the sharded forms that now run: an
    unknown drive raises; a gloo group's collectives on CUDA cannot be
    captured (ValueError naming NCCL); minimize_sharded and lm.minimize
    with the shard's reduce run the device loop in a group of one (gloo on
    the CPU) and take the host drive's path; the CLI's --shards 1 --drive
    jit runs and, like the JAX package's sharded jit drive, prints no
    iteration table."""
    _, tp = _pair(0)
    with pytest.raises(ValueError, match="drive"):
        lm.minimize(tp, device="cpu", config=lm.LMConfig(drive="bogus"))
    with pytest.raises(ValueError, match="NCCL"):
        sharded.check_graph_backend("gloo", torch.device("cuda", 0))
    cfg = lm.LMConfig(drive="jit", max_iter=6)
    (jit,) = multihost.run_ranks(_sharded_one_rank, ["cpu"], args=(tp, cfg))
    assert lm.LAST_JIT_RUN["reads"] == 1
    host = lm.minimize(tp, device="cpu", config=dataclasses.replace(cfg, drive="host"))
    assert _counts(jit) == _counts(host) and jit.energy == host.energy
    capsys.readouterr()
    rc = cli.main([tiny, "--shards", "1", "--drive", "jit", "--device", "cpu",
                   "--max-iters", "3", "--log-file", str(tmp_path / "r.log")])
    out = capsys.readouterr().out
    assert rc == cli.RETURN_SUCCESS
    assert "LM finished with status: Maximum Iterations Reached" in out
    assert not [ln for ln in out.splitlines() if ROW.match(ln)]
    assert "Backtrack LevMarq" not in out


@pytest.mark.parametrize("df32", [False, True], ids=["f64", "df32"])
def test_qrkit_without_pairs_on_the_jit_drive(df32):
    """qrkit on a problem without pair tables (the "rows" cache, whose
    prepare factors the camera gram by cuda_eigh.eigh: its plain version on
    the CPU) runs on the jit drive and takes the host drive's path bit for
    bit."""
    _, tp = _pair(1, n_cameras=5, n_points=30, obs_per_point=4,
                  inlier_threshold=2.0)
    tp = dataclasses.replace(tp, pairs=None)
    kw = dict(matmul_dtype="float32", geometry="df32") if df32 else {}
    jit, host = _drives(tp, "qrkit", max_iter=6, **kw)
    assert _counts(jit) == _counts(host) and jit.energy == host.energy
    assert torch.equal(jit.state.points, host.state.points)


def test_eigh_failure_stops_the_loop(monkeypatch):
    """A nonzero eigensolver info makes the gram factor NaN on the device:
    every trial of the iteration is non-finite, both drives stop the same
    way (ExceededLambdaMax after lambda grows past lambda_max), and
    debug_nans raises at the jit drive's read."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_eigh

    def failing(S):
        w, V, info = cuda_eigh.eigh_plain(S)
        return w, V, info + 1

    _, tp = _pair(1, n_cameras=5, n_points=30, obs_per_point=4,
                  inlier_threshold=2.0)
    tp = dataclasses.replace(tp, pairs=None)
    monkeypatch.setattr(cuda_eigh, "eigh", failing)
    C = schur._gram_sqrt_factor(torch.eye(4, dtype=torch.float64))
    assert bool(torch.isnan(C).all())
    jit, host = _drives(tp, "qrkit", max_iter=5)
    assert _counts(jit) == _counts(host)
    assert jit.status == lm.LMStatus.ExceededLambdaMax and jit.iterations == 1
    with pytest.raises(FloatingPointError, match="LM iteration 1"):
        lm.minimize(tp, "qrkit", device="cpu", config=lm.LMConfig(
            drive="jit", max_iter=5, debug_nans=True))


def test_cuda_eigh_on_the_cpu_is_the_plain_version():
    """On a CPU tensor cuda_eigh.eigh is torch.linalg.eigh with a zero
    info; the Jacobi kernels take only CUDA tensors."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_eigh

    rng = np.random.default_rng(3)
    A = rng.normal(size=(9, 9))
    S = torch.from_numpy(A + A.T)
    w, V, info = cuda_eigh.eigh(S)
    w0, V0 = torch.linalg.eigh(S)
    assert torch.equal(w, w0) and torch.equal(V, V0) and int(info) == 0
    with pytest.raises(ValueError, match="cpu"):
        cuda_eigh.jacobi_eigh(S)


def test_jit_polish_composes():
    """polish_iters runs both phases on the jit drive, as on the host."""
    _, tp = _pair(1, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    kw = dict(max_iter=20, matmul_dtype="float32", geometry="df32",
              polish_iters=3)
    jit, host = _drives(tp, "cholesky", **kw)
    assert _counts(jit) == _counts(host) and jit.energy == host.energy
    assert torch.equal(jit.state.points, host.state.points)


# -- one dispatch where nothing observes the run, as JAX's default -------------


def _chunks(res, chunk: int, start: int = 0) -> int:
    """Chunks of ``chunk`` iterations that a run of result ``res``, resumed
    at iteration ``start``, started: its reads where it runs in chunks."""
    started = res.iterations - start - (res.status in (
        lm.LMStatus.MaxItersReached, lm.LMStatus.TooManyFunctionEvaluation))
    return -(-started // chunk)


def test_chunked_defaults_to_false_in_both_packages():
    assert lm.LMConfig().chunked is jlm.LMConfig().chunked is False
    assert lm.LMConfig().chunk_size == jlm.LMConfig().chunk_size == 16


@pytest.fixture(scope="module")
def p16_to_stop():
    """p16, float64 cholesky, default config to its flatline stop, as one
    dispatch and with ``chunked=True``: {chunked: (result, LAST_JIT_RUN,
    calls of DeviceLoop.chunk)}."""
    tp = pm.load_bal_problem(P16, device="cpu")
    out = {}
    for chunked in (False, True):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            chunk = lm.DeviceLoop.chunk
            mp.setattr(lm.DeviceLoop, "chunk",
                       lambda self: calls.append(1) or chunk(self))
            res = lm.minimize(tp, config=lm.LMConfig(chunked=chunked), device="cpu")
        out[chunked] = (res, dict(lm.LAST_JIT_RUN), len(calls))
    return out


@pytest.mark.parametrize("chunked", [False, True], ids=["one-dispatch", "chunked"])
def test_p16_run_to_its_stop_reads(p16_to_stop, chunked):
    """The default config, which nothing observes, runs the loop once and
    reads the host once (JAX's one ``_minimize_jit``); ``chunked=True``
    reads once per chunk of 16 iterations. Both count every trial."""
    res, counted, calls = p16_to_stop[chunked]
    print(f"p16 f64 cholesky chunked={chunked}: {_counts(res)}, {counted}")
    assert res.status == lm.LMStatus.Success and res.iterations > 16
    want = _chunks(res, 16) if chunked else 1
    assert counted["reads"] == counted["replays"] == calls == want
    assert counted["chunked"] is chunked
    assert counted["slots"] == res.fun_evals - counted["prepares"]


def test_p16_one_dispatch_equals_chunked(p16_to_stop):
    """One dispatch and chunks of 16 end bit for bit alike: status,
    iterations, evaluations, energy, lambda and every state field."""
    one, chunked = p16_to_stop[False][0], p16_to_stop[True][0]
    assert _counts(one) == _counts(chunked)
    assert (one.energy, one.lam) == (chunked.energy, chunked.lam)
    for field in ("K", "R", "T", "k1", "k2", "points"):
        assert torch.equal(getattr(one.state, field), getattr(chunked.state, field))


OBSERVERS = ("verbose", "metrics", "checkpoint", "resume", "trace", "chunked")


@pytest.mark.parametrize("how", OBSERVERS)
def test_observed_runs_read_once_per_chunk(how, tmp_path, capsys):
    """A jit run with the iteration table, metrics, a checkpoint, a resume,
    a trace or ``chunked=True`` runs in chunks (JAX's chunked_loop): one
    read and one replay per chunk of ``chunk_size``, on the host drive's
    path bit for bit."""
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    cfg = lm.LMConfig(drive="jit", max_iter=7, chunk_size=2, tol_fun=1e-30,
                      verbose=how == "verbose", chunked=how == "chunked")
    kw, start = {}, 0
    if how == "metrics":
        kw["metrics_path"] = str(tmp_path / "m.jsonl")
    elif how == "checkpoint":
        kw["checkpoint_path"] = str(tmp_path / "c.npz")
    elif how == "trace":
        kw["trace"] = []
    elif how == "resume":
        start = 1
        kw["resume"] = {"iteration": start, "lam": 1e-2, "fun_evals": 2,
                        "energy_history": [0.0, 0.0]}
    res = lm.minimize(tp, device="cpu", config=cfg, **kw)
    counted = dict(lm.LAST_JIT_RUN)
    capsys.readouterr()
    host = lm.minimize(tp, device="cpu", resume=kw.get("resume"),
                       config=dataclasses.replace(cfg, drive="host", verbose=False))
    print(f"{how}: {_counts(res)}, {counted}")
    assert counted["chunked"] is True
    assert counted["reads"] == counted["replays"] == _chunks(res, 2, start) > 1
    assert _counts(res) == _counts(host) and res.energy == host.energy


@pytest.fixture(scope="module")
def sharded_runs():
    """2 gloo ranks on the CPU, 12 iterations of float64 cholesky on the
    sharded jit drive: as one dispatch, with ``chunked=True`` (which a
    shard ignores, as JAX's sharded drive does) and with a trace (in chunks
    of 2)."""
    import torch_sharded_worker as worker

    jp, _ = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    runs = [dict(name=name, kind="minimize", problem="syn", mode="cholesky",
                 trace=name == "traced",
                 config=dict(drive="jit", max_iter=12, chunk_size=2,
                             chunked=name == "chunked=True"))
            for name in ("chunked=False", "chunked=True", "traced")]
    return multihost.run_ranks(worker.cases, ["cpu"] * 2,
                               args=(runs, {"syn": convert.problem_to_numpy(jp)}),
                               timeout=240.0)


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_gloo_one_dispatch_equals_chunked(sharded_runs, rank):
    """Each rank's unchunked sharded jit run reads and replays once, like
    JAX's one ``jax.jit`` of the sharded run, with ``chunked=True`` too (a
    shard ignores it, as JAX's does), and ends bit for bit as its traced
    run, which reads once per chunk."""
    out = sharded_runs[rank]
    one, chunked = out["chunked=False"], out["traced"]
    print(f"rank {rank}: one dispatch {one['jit']}, traced {chunked['jit']}")
    for run in (one, out["chunked=True"]):
        assert run["jit"]["reads"] == run["jit"]["replays"] == 1
        assert run["jit"]["chunked"] is False
    started = chunked["iterations"] - (chunked["status"] == lm.LMStatus.MaxItersReached)
    assert chunked["jit"]["reads"] == chunked["jit"]["replays"] == -(-started // 2) > 1
    for k in ("iterations", "fun_evals", "status", "energy", "lam"):
        assert one[k] == chunked[k] == out["chunked=True"][k], k
    assert np.array_equal(one["points"], chunked["points"])
    assert np.array_equal(one["T"], chunked["T"])

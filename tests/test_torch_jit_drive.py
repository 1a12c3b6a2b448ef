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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_benchmarks_tpu import cli as jcli
from bundleadjustment_benchmarks_tpu.ops import projection as jproj
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu.utils.synthetic import make_synthetic_problem
from bundleadjustment_benchmarks_tpu_torch import cli, convert
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph, jacobian
from bundleadjustment_benchmarks_tpu_torch.parallel import sharded
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint
from test_torch_cli import (KEPT, RHO_RESOLVED, RTOL_F, RTOL_LAMBDA, RTOL_RHO,
                            TAU, write_synthetic_bal)

MODES = ("cholesky", "qrchol", "qrkit", "moreqr", "spqr")
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


def test_breakdown_branch_is_a_device_predicate():
    """The float32 Cholesky breakdown test decides on the predicate: an
    indefinite S takes the refined QR fallback (equal to it computed
    eagerly), a positive definite one the refined Cholesky solve."""
    rng = np.random.default_rng(0)
    n = 18
    A = rng.normal(size=(n, n))
    b = torch.from_numpy(rng.normal(size=n))
    for name, S64 in (("indefinite", A + A.T), ("definite", A @ A.T + n * np.eye(n))):
        S = torch.from_numpy(S64).to(torch.float32)
        x = schur._camera_solve_chol(S, b.to(torch.float32))
        # The two branches, eagerly.
        f64 = torch.float64
        S64t, b64 = S.to(f64), b.to(torch.float32).to(f64)
        d = torch.diagonal(S64t)
        dinv = torch.where(d > 0, torch.rsqrt(d.abs() + torch.finfo(f64).tiny),
                           torch.ones_like(d))
        Ss32 = (S64t * dinv[:, None] * dinv[None, :]).to(torch.float32)
        L, info = torch.linalg.cholesky_ex(Ss32)
        broke = bool(info != 0) or not bool(torch.isfinite(L).all())
        assert broke == (name == "indefinite")
        if broke:
            Q, R = torch.linalg.qr(Ss32)
            solve = lambda r: torch.linalg.solve_triangular(  # noqa: E731
                R, (Q.T @ r.to(torch.float32))[:, None], upper=True)[:, 0].to(f64)
        else:
            solve = lambda r: torch.cholesky_solve(  # noqa: E731
                r.to(torch.float32)[:, None], L)[:, 0].to(f64)
        ref = solve(b64 * dinv) * dinv
        for _ in range(2):
            ref = ref + solve((b64 - S64t @ ref) * dinv) * dinv
        assert torch.equal(x, ref.to(torch.float32)), name


def test_growth_table_and_reads():
    """The device's lambda growth table is the host drive's recurrence
    (saturating at inf), and the drive reads the host once per chunk."""
    table = lm.growth_table(2.0)
    inc, ref = 2.0, []
    for _ in range(12):
        ref.append(inc)
        inc = inc ** 1.5
    assert table[:12] == ref and table[-1] == math.inf
    assert lm.growth_table(1.0) == [1.0] * len(table)
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    cfg = lm.LMConfig(drive="jit", max_iter=3, chunk_size=2)
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
    """A run whose iterations reject trials (to the lambda-max stop) still
    reads the host once per chunk, and counts every trial on the device:
    the host drive's path, one read per chunk."""
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    jit, host = _drives(tp, "cholesky", max_iter=30, tol_fun=1e-30,
                        chunk_size=chunk_size)
    assert _counts(jit) == _counts(host) and jit.energy == host.energy
    assert jit.status == lm.LMStatus.ExceededLambdaMax
    assert jit.fun_evals - jit.iterations > jit.iterations  # rejections
    chunks = -(-jit.iterations // chunk_size)
    print(f"chunk {chunk_size}: {jit.iterations} iterations, "
          f"{jit.fun_evals} evaluations, {lm.LAST_JIT_RUN}")
    assert lm.LAST_JIT_RUN["reads"] == lm.LAST_JIT_RUN["replays"] == chunks
    assert lm.LAST_JIT_RUN["slots"] == jit.fun_evals - jit.iterations


def test_chunk_cap_raises_where_lambda_cannot_grow():
    """With lambda_increase_base 1 a rejected trial never ends its
    iteration (the host drive loops forever): the chunk stops at its cap of
    chunk_size * 129 trials and the run raises."""
    _, tp = _pair(0, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    cfg = lm.LMConfig(drive="jit", max_iter=50, chunk_size=2, tol_fun=1e-30,
                      lambda_increase_base=1.0)
    with pytest.raises(RuntimeError, match="258 trials without ending"):
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
    ignores the limits, which the graph reads from the device."""
    _, tp = _pair(0)
    cfg = lm.LMConfig(drive="jit")
    x0 = lm.step_functions(tp, "cholesky", cfg, "cpu")[2](tp.state)
    key = lm._graph_key(tp, "cholesky", cfg, x0, "cuda:0")
    other = dataclasses.replace(tp, inlier_threshold=tp.inlier_threshold * 2)
    assert lm._graph_key(other, "cholesky", cfg, x0, "cuda:0") != key
    assert lm._graph_key(tp, "cholesky", dataclasses.replace(
        cfg, max_iter=3, max_fun_ev=7, tol_fun=1e-3), x0, "cuda:0") == key


def test_jit_refusals(tiny, tmp_path):
    """drive='jit' has no sharded form: a sharded reduce raises, so does
    minimize_sharded, and the CLI's --shards 2 --drive jit returns 1."""

    class Sharded(schur.Reduce):
        sharded = True

    _, tp = _pair(0)
    with pytest.raises(ValueError, match="sharded"):
        lm.minimize(tp, device="cpu", reduce=Sharded(),
                    config=lm.LMConfig(drive="jit"))
    with pytest.raises(ValueError, match="drive='jit'"):
        sharded.minimize_sharded(None, config=lm.LMConfig(drive="jit"))
    with pytest.raises(ValueError, match="drive"):
        lm.minimize(tp, device="cpu", config=lm.LMConfig(drive="bogus"))
    rc = cli.main([tiny, "--shards", "2", "--drive", "jit", "--device", "cpu",
                   "--log-file", str(tmp_path / "r.log")])
    assert rc == cli.RETURN_WRONG_INPUT_PARAMS


def test_jit_polish_composes():
    """polish_iters runs both phases on the jit drive, as on the host."""
    _, tp = _pair(1, n_cameras=6, n_points=40, obs_per_point=4,
                  inlier_threshold=2.0)
    kw = dict(max_iter=20, matmul_dtype="float32", geometry="df32",
              polish_iters=3)
    jit, host = _drives(tp, "cholesky", **kw)
    assert _counts(jit) == _counts(host) and jit.energy == host.energy
    assert torch.equal(jit.state.points, host.state.points)

"""Backtracking Levenberg-Marquardt driver (reference
BacktrackLevMarqCholesky.h:190-361):

  * strict-decrease acceptance (energyTest < energy, :299);
  * rho = (E - E') / (dx^T (lambda dx + JtRes)) (:300-301);
  * Nielsen decrease on accept: lambda *= max(1/3, 1 - (2 rho - 1)^3),
    clamped at lambda_min (:303-305); nu reset to 2 (:312);
  * on reject: stop with ExceededLambdaMax if lambda > lambda_max
    (:325-328), else lambda *= nu, nu <- nu^1.5 (:331-334);
  * flatline stop against a depth-2 history ring buffer:
    |E - max(hist)| < tolFun * E once iter > 2 (:343-350, :150, :316);
  * ``discard_final_step``: on the flatline path the reference breaks
    before ``x = xTest`` (:344-353), so the final accepted step is dropped;
  * non-finite guard (a deviation from the reference): a NaN energy or
    lambda stops with ExceededLambdaMax instead of looping forever.

Each outer iteration runs ``prepare`` (residuals, Jacobian, the Schur
context; the chain kernel ``cuda_chain.fused_blocks_energy`` on the df32
drive) and then damping ``trial``s (the reduced solve, the manifold step and
the trial energy, ``cuda_chain.fused_energy`` on the df32 drive). Two drives
run that control flow (``LMConfig.drive``):

  * "host" (``lm_loop``, the default): plain Python over device-resident
    tensors. The host reads the trial energy and rho's denominator once per
    trial (with the outer energy on the first trial) for the accept test, a
    float32 Cholesky camera solve reads its breakdown flag once, and qrkit's
    prepare on a problem without pair tables reads the error flag of its
    one ``torch.linalg.eigh``. LM scalars are Python floats (float64).
  * "jit" (``DeviceLoop``, the JAX package's default and bench.py's drive,
    JAX lm.py:286-786): the LM scalars are float64 device tensors and every
    decision is taken on the device; on CUDA one chunk of ``chunk_size``
    iterations (a loop of damping trials with their control flow) is
    captured once into a CUDA graph with conditional nodes
    (``ops/cuda_graph.py``) and replayed, and the host reads the state once
    per chunk. Its table, JSONL records and
    checkpoints follow JAX's chunked drive. Same arithmetic as the host
    drive: on one device the two give the same LM path.

The loop also carries the host drive's observability (JAX lm.py:792-939):
the reference's per-trial iteration table (``LMConfig.verbose``), one JSONL
metrics record per trial, checkpoints of the accepted state and resuming
from one (``utils/checkpoint.py``), all from the values the trial's one host
read already brought back. ``LMConfig.polish_iters`` runs the two-phase
drive: the df32 descent, then a float64 polish from its endpoint.

The sharded path (``parallel/sharded.py``) runs this same loop on each
rank's slice of the points, with a ``schur.Reduce`` that all-reduces the
partial sums: every rank reads the same trial scalars and so takes the same
decisions.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
import time
from typing import NamedTuple, Optional

import torch

from bundleadjustment_benchmarks_tpu_torch import resolve_device
from bundleadjustment_benchmarks_tpu_torch.models import problem as problem_mod
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, cuda_graph, jacobian, projection
from bundleadjustment_benchmarks_tpu_torch.ops import twofloat as tf
from bundleadjustment_benchmarks_tpu_torch.solvers import schur


class LMStatus(enum.IntEnum):
    """Reference status enum (BacktrackLevMarqCholesky.h:27-34)."""

    NotStarted = -2
    Running = -1
    Success = 0
    ExceededLambdaMax = 1
    TooManyFunctionEvaluation = 2
    MaxItersReached = 3


#: Reference statusToString (BacktrackLevMarqCholesky.h:36-51).
STATUS_STRINGS = {
    LMStatus.NotStarted: "Not Started",
    LMStatus.Running: "Running",
    LMStatus.Success: "Success (Energy Flatlined)",
    LMStatus.ExceededLambdaMax: "Success (Exceeded Maximum Lambda)",
    LMStatus.TooManyFunctionEvaluation: "Too Many Function Evaluations",
    LMStatus.MaxItersReached: "Maximum Iterations Reached",
}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """LM hyper-parameters; defaults equal the reference's
    (BacktrackLevMarqCholesky.h:110-132)."""

    tol_fun: float = 1e-8
    max_iter: int = 1_000_000
    max_fun_ev: int = 1_000_000
    lambda_min: float = 1e-10
    lambda_max: float = 1e10
    lambda_increase_base: float = 2.0
    discard_final_step: bool = True
    #: "float32": the cached Schur stacks and the reduced system in float32
    #: (the reduced solve refines in float64); None = the problem dtype.
    matmul_dtype: Optional[str] = None
    #: None = state dtype geometry (float64); "df32" = two-float float32.
    geometry: Optional[str] = None
    #: Run the df32 chain through the CUDA kernels (ops/cuda_chain.py).
    #: None = exactly when the device is CUDA and geometry is "df32";
    #: True off CUDA raises; False on CUDA is for kernel-vs-plain checks.
    kernels: Optional[bool] = None
    #: History depth of the flatline test (BacktrackLevMarqCholesky.h:150).
    energy_history_size: int = 2
    #: Iterative-refinement passes on each trial's step (schur.refine_step):
    #: a float64 residual and a correction solve of the same system. Only
    #: the chol camera solver (cholesky, qrchol, moreqr); qrkit and spqr
    #: raise. 0 = off.
    refine_steps: int = 0
    #: Print the reference's iteration table (BacktrackLevMarqCholesky.h:53-81).
    verbose: bool = False
    #: Two-phase drive: after a df32 or float32-matmul run stops, continue
    #: from its endpoint in float64 (geometry None, matmul_dtype None) for up
    #: to this many iterations. 0 = off; ignored for a pure float64 config.
    polish_iters: int = 0
    #: Raise FloatingPointError at the first non-finite energy or rho
    #: denominator the loop reads (the counterpart of jax_debug_nans).
    debug_nans: bool = False
    #: "host": the Python loop, one host read per trial (``lm_loop``);
    #: "jit": the device-resident drive, JAX's default and bench.py's drive
    #: (``DeviceLoop``): on CUDA every prepare and trial runs from one
    #: captured CUDA graph with conditional nodes, and the host reads the LM
    #: scalars once per chunk.
    drive: str = "host"
    #: Outer iterations per host read of the jit drive (JAX lm.py:139-143).
    chunk_size: int = 16

    def use_kernels(self, device: torch.device) -> bool:
        if self.kernels and device.type != "cuda":
            raise ValueError(
                f"LMConfig(kernels=True) needs a CUDA device, got {device}")
        if self.geometry != "df32":
            return False
        return device.type == "cuda" if self.kernels is None else self.kernels


class LMResult(NamedTuple):
    state: problem_mod.BAState
    status: LMStatus
    iterations: int
    fun_evals: int
    energy: float
    lam: float


#: Flatline tolerance of the two-phase drive's fast phase, which runs at
#: max(tol_fun, this): it hands over once its own step noise stalls the
#: descent (JAX lm.py:129-136, a field of JAX's LMConfig).
_POLISH_FAST_TOL = 1e-6


def _mm(matmul_dtype: Optional[str]):
    if matmul_dtype is None:
        return None
    if matmul_dtype != "float32":
        raise ValueError(f"matmul_dtype must be None or 'float32', got "
                         f"{matmul_dtype!r}")
    return torch.float32


# -- per-iteration kernels ---------------------------------------------------------


def _prepare(state, problem, mode: str, matmul_dtype: Optional[str] = None,
             reduce: schur.Reduce = schur.LOCAL):
    """Residuals, Jacobian, energy and the Schur context (state geometry).
    Returns (ctx, float64 energy, float64 lambda0). On a shard (``reduce``)
    the energy and the camera totals cover every rank."""
    mm = _mm(matmul_dtype)
    blocks = jacobian.residuals_and_jacobian(
        state, problem.obs, problem.tau2, compute_dtype=mm)
    (energy,) = reduce.sum(projection.compensated_square_sum(blocks.f))
    ctx = schur.build_context(blocks, problem, mode, mm_dtype=mm, reduce=reduce)
    return ctx, energy, schur.initial_lambda(ctx, mode).to(torch.float64)


def _prepare_fast(fast, problem, mode: str, matmul_dtype: Optional[str] = None,
                  kernels: bool = False, reduce: schur.Reduce = schur.LOCAL):
    """df32 prepare. ``kernels=True`` runs the residual/Jacobian/energy
    chain as one CUDA kernel launch (same math as the plain path)."""
    mm = _mm(matmul_dtype)
    if kernels:
        blocks, energy = cuda_chain.fused_blocks_energy(
            fast, problem.obs, problem.tau2)
    else:
        blocks, energy = cuda_chain.fused_blocks_energy_plain(
            fast, problem.obs, problem.tau2)
    (energy,) = reduce.sum(energy)
    ctx = schur.build_context(blocks, problem, mode, mm_dtype=mm, reduce=reduce)
    return ctx, energy, schur.initial_lambda(ctx, mode).to(torch.float64)


def _solve(ctx, lam, problem, mode: str, mm, refine: int,
           reduce: schur.Reduce = schur.LOCAL):
    """The damped step and ``refine`` refinement passes on it."""
    dxp, dxc = schur.solve_damped(ctx, lam, problem, mode, mm_dtype=mm,
                                  reduce=reduce)
    for _ in range(refine):
        dxp, dxc = schur.refine_step(ctx, lam, problem, mode, dxp, dxc,
                                     mm_dtype=mm)
    return dxp, dxc


def _trial(ctx, state, lam, problem, mode: str,
           matmul_dtype: Optional[str] = None, refine: int = 0,
           reduce: schur.Reduce = schur.LOCAL):
    """One damping trial: solve, step, trial energy, rho's denominator."""
    mm = _mm(matmul_dtype)
    dxp, dxc = _solve(ctx, lam, problem, mode, mm, refine, reduce)
    x_test = problem_mod.apply_step(state, dxp, dxc)
    (e_test,) = reduce.sum(projection.energy(x_test, problem.obs, problem.tau2,
                                             compute_dtype=mm))
    return x_test, e_test, schur.gradient_dot(ctx, dxp, dxc, lam, reduce)


def _trial_fast(ctx, fast, lam, problem, mode: str,
                matmul_dtype: Optional[str] = None, kernels: bool = False,
                refine: int = 0, reduce: schur.Reduce = schur.LOCAL):
    """df32 damping trial: the solve runs at float32 lambda (``lam`` a
    float or a 0-dim float64 tensor, rounded alike)."""
    mm = _mm(matmul_dtype)
    if torch.is_tensor(lam):
        lam32 = lam.to(torch.float32).to(torch.float64)
    else:
        lam32 = float(torch.tensor(lam, dtype=torch.float32))
    dxp, dxc = _solve(ctx, lam32, problem, mode, mm, refine, reduce)
    x_test = problem_mod.apply_step_fast(fast, dxp, dxc)
    if kernels:
        e_test = cuda_chain.fused_energy(x_test, problem.obs, problem.tau2)
    else:
        e_test = cuda_chain.fused_energy_plain(x_test, problem.obs,
                                               problem.tau2)
    (e_test,) = reduce.sum(e_test)
    return x_test, e_test, schur.gradient_dot(ctx, dxp, dxc, lam, reduce)


def step_functions(problem, mode: str, config: "LMConfig", device,
                   reduce: schur.Reduce = schur.LOCAL):
    """``lm_loop``'s (prepare, trial) for ``config``'s drive on ``device``,
    and (to_loop, to_state), which map a BAState to the loop's state (a
    FastBAState on the df32 drive) and back. With a sharded ``reduce``
    (``parallel.sharded``) both total their partial sums over the ranks."""
    schur.check_mode(mode)
    if config.geometry not in (None, "df32"):
        raise ValueError(f"unknown geometry {config.geometry!r}")
    if config.refine_steps and schur.MODE_STRATEGY[mode][1] != "chol":
        raise ValueError(
            f"refine_steps={config.refine_steps} needs the chol camera "
            f"solver (cholesky, qrchol, moreqr); mode {mode!r} keeps its rhs "
            "in its lambda-free cache")
    if config.refine_steps and reduce.sharded:
        raise ValueError(
            f"refine_steps={config.refine_steps} is not supported on the "
            "sharded path (its residual sums over every rank's observations)")
    kernels = config.use_kernels(torch.device(device))
    mm, refine = config.matmul_dtype, config.refine_steps
    if config.geometry == "df32":
        def prepare(x):
            return _prepare_fast(x, problem, mode, mm, kernels, reduce)

        def trial(ctx, x, lam):
            return _trial_fast(ctx, x, lam, problem, mode, mm, kernels, refine,
                               reduce)

        dtype = problem.state.T.dtype
        return (prepare, trial, problem_mod.to_fast,
                lambda x: problem_mod.from_fast(x, dtype=dtype))

    def prepare(x):
        return _prepare(x, problem, mode, mm, reduce)

    def trial(ctx, x, lam):
        return _trial(ctx, x, lam, problem, mode, mm, refine, reduce)

    return prepare, trial, (lambda s: s), (lambda x: x)


# -- the loop ----------------------------------------------------------------------


def _output_header():
    print("############################## Backtrack LevMarq"
          " ###############################")
    print("-" * 80)


def _output_iter_header():
    print(f"{'Iter':>5}{'Status':>15}{'f':>15}{'rho':>15}{'lambda':>15}"
          f"{'Elapsed':>15}")
    print("-" * 80)


def _output_iter(it, status, fval, rho, lam, elapsed):
    # rho None: a Rejected row that the jit drive synthesized from its
    # iteration record, whose rho it did not keep (JAX lm.py:807-815).
    rho_s = f"{rho:>15.6g}" if rho is not None else f"{'-':>15}"
    print(f"{it:>5}{status:>15}{fval:>15.6g}{rho_s}{lam:>15.6g}"
          f"{elapsed:>14.4g}s")


class RunLog:
    """What one LM run reports as it goes: the reference's iteration table
    (``verbose``), one JSONL record per trial appended to ``metrics_path``
    (keys iter, status, f, rho, lambda, elapsed_s, and phase when
    ``phase`` is set), a checkpoint of the accepted state every
    ``checkpoint_every`` iterations, and one dict per accepted iteration
    appended to ``trace`` (iter, energy: the accepted energy, lam: the
    lambda after the update, and phase when set). ``to_state`` maps the
    loop state to the BAState a checkpoint holds. ``write=False`` (a
    sharded run's ranks other than 0) prints and writes nothing but still
    calls ``to_state`` where a checkpoint falls due, since on a shard that
    is a collective. Use it as a context manager.

    ``capture_s`` (the jit drive, JAX's chunked_loop): the table says the
    capture is excluded and Elapsed is a chunk's average per trial, the
    metrics file gets a {"compile_s": capture_s} record first, and every
    trial record carries ``elapsed_kind`` and ``synthesized``."""

    def __init__(self, verbose: bool = False,
                 metrics_path: Optional[str] = None,
                 phase: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, to_state=None,
                 write: bool = True, trace: Optional[list] = None,
                 capture_s: Optional[float] = None):
        self.verbose = verbose and write
        self.metrics_path = metrics_path if write else None
        self.phase = phase
        self.checkpoint_path = checkpoint_path if checkpoint_every else None
        self.checkpoint_every = checkpoint_every
        self.to_state = to_state
        self.write = write
        self.trace = trace
        self.capture_s = capture_s
        self._metrics = None

    def __enter__(self):
        if self.verbose:
            _output_header()
            if self.capture_s is not None:
                print(f"(chunked jit drive: capture {self.capture_s:.3g}s "
                      "excluded; Elapsed = chunk-amortized avg per trial)")
            _output_iter_header()
        if self.metrics_path:
            self._metrics = open(self.metrics_path, "a")
            if self.capture_s is not None:
                self._record({"compile_s": self.capture_s})
        return self

    def __exit__(self, *exc):
        if self.verbose:
            print("-" * 80)
        if self._metrics:
            self._metrics.close()
            self._metrics = None

    def _record(self, rec: dict) -> None:
        if self.phase:
            rec["phase"] = self.phase
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()

    def trial(self, it: int, status: str, f: float, rho: Optional[float],
              lam: float, elapsed: float, synthesized: bool = False) -> None:
        if self.verbose:
            _output_iter(it, status, f, rho, lam, elapsed)
        if self._metrics:
            rec = {"iter": it, "status": status, "f": f, "rho": rho,
                   "lambda": lam, "elapsed_s": elapsed}
            if self.capture_s is not None:
                rec.update(elapsed_kind="avg_per_trial_chunk",
                           synthesized=synthesized)
            self._record(rec)

    def accepted(self, it: int, x, lam: float, fun_evals: int, hist) -> None:
        self.traced(it, hist[it % len(hist)], lam)
        if self.checkpoint_path and it % self.checkpoint_every == 0:
            self.save(x, lam, it, fun_evals, hist)

    def traced(self, it: int, energy: float, lam: float) -> None:
        if self.trace is not None:
            rec = {"iter": it, "energy": energy, "lam": lam}
            if self.phase:
                rec["phase"] = self.phase
            self.trace.append(rec)

    def save(self, x, lam: float, it: int, fun_evals: int, hist) -> None:
        """Checkpoint ``x`` (the loop state) with the LM scalars."""
        from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint

        state = self.to_state(x)
        if self.write:
            checkpoint.save_checkpoint(
                self.checkpoint_path, state, lam=lam, iteration=it,
                fun_evals=fun_evals, energy_history=list(hist))


def lm_loop(x0, prepare, trial, config: LMConfig, resume=None,
            run_log: Optional[RunLog] = None):
    """The LM control flow around ``prepare(x) -> (ctx, energy, lam0)`` and
    ``trial(ctx, x, lam) -> (x_test, e_test, rho_scale)``.

    ``resume``: a checkpoint's meta (``utils.checkpoint.load_checkpoint``):
    lambda, iteration, fun_evals and the energy history continue from it,
    and the first-iteration lambda rule is skipped. ``run_log`` gets every
    trial's row (Elapsed: the host clock after the trial's one host read,
    from the start of the iteration or of the previous rejected trial) and
    every accepted state.

    Returns (x, status, iterations, fun_evals, energy, lam) with the
    reference's bookkeeping: a run stopped by max_iter or max_fun_ev counts
    the iteration that found the limit."""
    x = x0
    lam = math.nan  # set from the first prepare's schur.initial_lambda
    lam_inc = float(config.lambda_increase_base)
    it = fun_evals = 0
    size = config.energy_history_size
    hist = [0.0] * size
    if resume:
        lam = float(resume.get("lam", lam))
        it = int(resume.get("iteration", 0))
        fun_evals = int(resume.get("fun_evals", 0))
        hist = list(resume.get("energy_history", []))[:size]
        hist += [0.0] * (size - len(hist))
    status = LMStatus.Running
    energy = math.inf
    while it + 1 <= config.max_iter and fun_evals <= config.max_fun_ev:
        it += 1
        t0 = time.perf_counter()
        ctx, energy_t, lam0 = prepare(x)
        fun_evals += 1
        if it == 1 and not resume:
            lam = float(lam0)
        while True:
            x_t, e_t, rho_scale = trial(ctx, x, lam)
            fun_evals += 1
            # One host read per trial; the outer energy rides along.
            e_t, rho_scale, energy = torch.stack(
                [v.to(torch.float64) for v in (e_t, rho_scale, energy_t)]
            ).tolist()
            elapsed = time.perf_counter() - t0
            if config.debug_nans and not all(
                    map(math.isfinite, (e_t, rho_scale, energy))):
                raise FloatingPointError(
                    f"LM iteration {it}: energy {energy}, trial energy {e_t}, "
                    f"rho denominator {rho_scale}")
            if e_t < energy:
                rho = (energy - e_t) / rho_scale
                t = 2.0 * rho - 1.0
                lam = max(lam * max(1.0 / 3.0, 1.0 - t * (t * t)),
                          config.lambda_min)
                if run_log:
                    run_log.trial(it, "Accepted", energy, rho, lam, elapsed)
                lam_inc = float(config.lambda_increase_base)
                energy = e_t
                hist[it % size] = energy
                break
            if run_log:
                run_log.trial(it, "Rejected", energy, 0.0, lam, elapsed)
            if lam > config.lambda_max or not (
                    math.isfinite(lam) and math.isfinite(energy)):
                status = LMStatus.ExceededLambdaMax
                break
            lam *= lam_inc
            lam_inc = lam_inc ** 1.5
            t0 = time.perf_counter()
        if status != LMStatus.Running:
            break
        if run_log:
            run_log.accepted(it, x_t, lam, fun_evals, hist)
        if it > size and abs(energy - max(hist)) < config.tol_fun * energy:
            status = LMStatus.Success
            if not config.discard_final_step:
                x = x_t
            break
        x = x_t
    if status == LMStatus.Running:
        it += 1
        status = (LMStatus.MaxItersReached if it > config.max_iter
                  else LMStatus.TooManyFunctionEvaluation)
    return x, status, it, fun_evals, energy, lam


# -- the device-resident drive (drive="jit") --------------------------------------

#: The jit drive's float64 state vector: the LM scalars of the JAX package's
#: _OuterState (lam, it, fun_evals, status, energy; the flatline history
#: follows them), the current outer iteration's (``between``: 1 between
#: iterations, 0 inside one; f: its prepare's energy; lam0: its first
#: trial's lambda; trials so far), the last trial's energy, the trials run
#: in this chunk, the first non-finite trial read (for debug_nans), the
#: chunk's iteration bounds (set on the device as it starts), then what the
#: host sets: the chunk's cap on trials and the limits (JAX's traced
#: _Limits: changing them does not recapture).
_DYN = ("lam", "it", "fun_evals", "status", "energy", "between", "f", "lam0",
        "trials", "e_trial", "slots", "bad_it", "bad_energy", "bad_e_test",
        "bad_rho_scale", "chunk_start", "chunk_end")
_HOST = ("slot_cap", "max_iter", "max_fun_ev", "tol_fun")
#: The entries that an iteration's start and a trial write (a trial also
#: writes the flatline history).
_BEGIN_SET = ("it", "fun_evals", "f", "lam", "lam0", "trials", "between")
_STEP_SET = ("lam", "fun_evals", "trials", "between", "status", "energy",
             "e_trial", "slots", "bad_it", "bad_energy", "bad_e_test",
             "bad_rho_scale")
#: One record per outer iteration (JAX's _IterRecord, plus the energy it
#: ended at; its lam_inc0 is always lambda_increase_base, since lam_inc
#: resets at every accept): enough to rebuild every trial's table row.
_REC = ("f", "rho", "lam0", "lam_out", "n_trials", "accepted", "energy_out")
#: Entries of the lambda growth table: lam_inc after n rejects in a row
#: (base, base^1.5, ...), saturated at the last (inf for any base > 1).
_GROWTH = 128


def _leaves(x):
    if isinstance(x, problem_mod.FastBAState):
        return [x.K, x.R, x.T, x.k1, x.k2, x.points.hi, x.points.lo]
    return [x.K, x.R, x.T, x.k1, x.k2, x.points]


def _from_leaves(like, leaves):
    K, R, T, k1, k2, *pts = leaves
    if isinstance(like, problem_mod.FastBAState):
        return problem_mod.FastBAState(K=K, R=R, T=T, k1=k1, k2=k2,
                                       points=tf.DF(*pts))
    return problem_mod.BAState(K=K, R=R, T=T, k1=k1, k2=k2, points=pts[0])


def growth_table(base: float) -> list:
    """lam_inc after 0, 1, ... rejects: the host drive's ``lam_inc **
    1.5`` recurrence, in Python floats (so the two drives agree bit for
    bit), saturating at inf."""
    table = [float(base)]
    for _ in range(_GROWTH - 1):
        try:
            table.append(table[-1] ** 1.5)
        except OverflowError:
            table.append(math.inf)
    return table


class DeviceLoop:
    """The LM loop of the jit drive (JAX lm.py:286-786) on device state.

    ``chunk()`` is one chunk of the run, all decided on the device from the
    state vector ``sv``: it notes the chunk's first iteration and then runs
    trial slots while the run is live (Running, and inside an iteration or
    free to start one: the top-of-iteration stop checks, as in JAX's while
    condition, with the chunk's end among them). A slot starts the next
    iteration where it is between two (``prepare``, its lambda rule
    ``lam0 = where(it == 1, rule, lam)``) and runs one trial: the accept
    test, the Nielsen decrease or the reject growth, the non-finite guard,
    the depth-2 flatline test, the advance of the state
    (``discard_final_step``) and the iteration's record. The host applies
    _finalize_limits' bookkeeping after the last read.

    JAX's structures map onto it: ``sv`` holds _OuterState's scalars (the
    state x is the static ``x``) with the limits of _Limits beside them
    (device values: other limits need no new capture), ``rec`` holds one
    _IterRecord per iteration of the chunk, a slot is _make_outer's
    outer_step cut at each trial (the inner while loop becomes successive
    slots, ``between`` says whether the next slot starts an iteration),
    ``run``'s first write is _init_outer_state and its end
    _finalize_limits. lam_inc is not carried: after n rejects in a row it
    is ``growth_table``'s n-th entry, the host drive's recurrence.

    On CUDA the chunk is captured once into a ``cuda_graph.DeviceGraph``
    (its loop of slots, their two branches and the float32 Cholesky's
    fallback are conditional nodes) and ``run`` replays it; on the CPU
    ``run`` calls it. Either way the host reads the state once per chunk of
    ``config.chunk_size`` outer iterations. A chunk stops after
    ``chunk_size * (_GROWTH + 1)`` trials, more than its iterations can take
    where lambda grows (the growth table reaches inf by its last entry for
    any base above 1); ``run`` raises if that cap ended a chunk, where the
    host drive would loop forever."""

    def __init__(self, x0, prepare, trial, config: LMConfig, device):
        self.config = config
        self.device = torch.device(device)
        self.prepare, self.trial = prepare, trial
        size = config.energy_history_size
        hist = tuple(f"hist{i}" for i in range(size))
        names = _DYN + hist + _HOST
        self.pos = {n: i for i, n in enumerate(names)}
        f64 = torch.float64
        self.sv = torch.zeros(len(names), dtype=f64, device=self.device)
        self.at = {
            k: torch.tensor([self.pos[n] for n in v]).to(self.device)
            for k, v in (("begin", _BEGIN_SET), ("step", _STEP_SET + hist))}
        self.rec = torch.zeros((config.chunk_size, len(_REC)), dtype=f64,
                               device=self.device)
        self.table = growth_table(config.lambda_increase_base)
        self.table_dev = torch.tensor(self.table, dtype=f64).to(self.device)
        self.hist_slot = torch.arange(size, device=self.device)
        self.x = _from_leaves(x0, [t.clone() for t in _leaves(x0)])
        self.ctx = None
        self.graph = None
        self.reads = self.replays = self.slots = 0

    def _v(self, name):
        return self.sv[self.pos[name]]

    def _write(self, which: str, values) -> None:
        """Set the entries named by ``_BEGIN_SET`` or ``_STEP_SET`` (and the
        history) to ``values``, in one scatter."""
        self.sv.index_copy_(0, self.at[which], torch.stack(
            [v.to(torch.float64) for v in values]))

    # -- the chunk -------------------------------------------------------------------

    def chunk(self):
        v = self._v
        self.sv[self.pos["chunk_start"]].copy_(v("it"))
        self.sv[self.pos["chunk_end"]].copy_(v("it") + self.config.chunk_size)
        self.sv[self.pos["slots"]].zero_()
        cuda_graph.device_while(self._live, self._slot)

    def _live(self):
        v = self._v
        between = v("between") > 0
        may_start = ((v("it") + 1 <= v("max_iter"))
                     & (v("fun_evals") <= v("max_fun_ev"))
                     & (v("it") < v("chunk_end")))
        return ((v("status") == float(LMStatus.Running))
                & (~between | may_start) & (v("slots") < v("slot_cap")))

    def _slot(self):
        cuda_graph.device_if(self._v("between") > 0, self._begin)
        self._step()

    def _begin(self):
        v = self._v
        self.ctx, energy, lam0_rule = self.prepare(self.x)
        it = v("it") + 1
        lam0 = torch.where(it == 1, lam0_rule.to(torch.float64), v("lam"))
        zero = self.sv.new_zeros(())
        self._write("begin", (it, v("fun_evals") + 1, energy, lam0, lam0, zero,
                              zero))

    def _step(self):
        v, cfg, f64 = self._v, self.config, torch.float64
        lam, f, it, trials = v("lam"), v("f"), v("it"), v("trials")
        x_t, e_t, rho_scale = self.trial(self.ctx, self.x, lam)
        e_t, rho_scale = e_t.to(f64), rho_scale.to(f64)
        lam_inc = torch.index_select(
            self.table_dev, 0,
            trials.to(torch.int64).clamp(max=_GROWTH - 1).view(1)).view(())
        accepted = e_t < f
        # Accept: Nielsen decrease (BacktrackLevMarqCholesky.h:299-316).
        rho = (f - e_t) / rho_scale
        t = 2.0 * rho - 1.0
        lam_acc = torch.clamp(lam * torch.clamp(1.0 - t * (t * t), min=1.0 / 3.0),
                              min=cfg.lambda_min)
        # Reject: the stop check precedes the growth (:325-334); a
        # non-finite lambda or energy stops too.
        finite = torch.isfinite(lam) & torch.isfinite(f)
        stop = ~accepted & ((lam > cfg.lambda_max) | ~finite)
        grow = ~accepted & ~stop
        lam_new = torch.where(accepted, lam_acc,
                              torch.where(grow, lam * lam_inc, lam))
        done = accepted | stop
        e_new = torch.where(accepted, e_t, f)
        size = cfg.energy_history_size
        h0 = self.pos["hist0"]
        hist = self.sv[h0:h0 + size]
        hist_new = torch.where(
            accepted & (self.hist_slot == it.to(torch.int64) % size), e_new, hist)
        flat = accepted & (it > size) & (
            torch.abs(e_new - hist_new.max()) < v("tol_fun") * e_new)
        status = torch.where(
            stop, self.sv.new_full((), float(LMStatus.ExceededLambdaMax)),
            torch.where(flat, self.sv.new_full((), float(LMStatus.Success)),
                        v("status")))
        # Advance while Running (the reference's final-step discard,
        # :344-353) unless discard_final_step is off.
        advance = accepted & ~flat if cfg.discard_final_step else accepted
        for dst, src in zip(_leaves(self.x), _leaves(x_t)):
            dst.copy_(torch.where(advance, src, dst))
        bad = ~(torch.isfinite(e_t) & torch.isfinite(rho_scale)
                & torch.isfinite(f))
        first_bad = bad & (v("bad_it") == 0)
        n_trials = trials + 1
        self.rec.index_copy_(0, (it - v("chunk_start") - 1).to(torch.int64).clamp(
            0, cfg.chunk_size - 1).view(1), torch.stack([
                f, rho, v("lam0"), lam_new, n_trials, accepted.to(f64),
                e_new]).view(1, -1))
        self._write("step", (
            lam_new, v("fun_evals") + 1, n_trials, done, status,
            torch.where(done, e_new, v("energy")), e_t, v("slots") + 1,
            torch.where(first_bad, it, v("bad_it")),
            torch.where(first_bad, f, v("bad_energy")),
            torch.where(first_bad, e_t, v("bad_e_test")),
            torch.where(first_bad, rho_scale, v("bad_rho_scale")),
            *hist_new.unbind()))

    # -- capture and the host loop -----------------------------------------------

    def capture(self, kernels: bool) -> float:
        """Capture ``chunk`` into a CUDA graph after one eager prepare and
        trial on the capture stream (cuBLAS/cuSOLVER handles and
        workspaces, the chain kernels' workspace and launch counters, the
        per-device index tables). Returns the capture's seconds, warm-up
        excluded. A failed capture raises."""
        graph = cuda_graph.DeviceGraph(self.device)
        with torch.cuda.stream(graph.stream):
            if kernels:
                cuda_chain.prepare_capture(self.device)
            ctx, _, lam0 = self.prepare(self.x)
            self.trial(ctx, self.x, lam0.to(torch.float64))
            del ctx
        # The warm-up's memory goes back to the device before the graph's
        # pool takes its own.
        torch.cuda.empty_cache()
        graph.capture(self.chunk)
        self.graph = graph
        return graph.capture_s

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()
            self.graph = None
        self.ctx = None

    def _init(self, x0, cfg: LMConfig, lam=math.nan, it=0, fun_evals=0,
              hist=(), slot_cap=None) -> None:
        """Copy ``x0`` into the loop's state and set the LM scalars: those
        given (a fresh run's or a checkpoint's) and ``cfg``'s limits."""
        for dst, src in zip(_leaves(self.x), _leaves(x0)):
            dst.copy_(src)
        pos, size = self.pos, cfg.energy_history_size
        init = [0.0] * len(self.sv)
        i32max = 2**31 - 1
        init[pos["lam"]], init[pos["it"]], init[pos["fun_evals"]] = lam, it, fun_evals
        init[pos["status"]] = float(LMStatus.Running)
        init[pos["energy"]] = math.inf
        init[pos["between"]] = 1.0
        hist = list(hist)[:size]
        init[pos["hist0"]:pos["hist0"] + size] = hist + [0.0] * (size - len(hist))
        init[pos["slot_cap"]] = (self.config.chunk_size * (_GROWTH + 1)
                                 if slot_cap is None else slot_cap)
        init[pos["max_iter"]] = min(cfg.max_iter, i32max)
        init[pos["max_fun_ev"]] = min(cfg.max_fun_ev, i32max)
        init[pos["tol_fun"]] = cfg.tol_fun
        self.sv.copy_(torch.tensor(init, dtype=torch.float64))

    def _chunk(self) -> None:
        (self.graph.replay if self.graph is not None else self.chunk)()
        self.replays += 1

    def _read(self, observe: bool) -> list:
        self.reads += 1
        if observe:
            return torch.cat([self.sv, self.rec.view(-1)]).tolist()
        return self.sv.tolist()

    def first_trial(self, x0, lam: float) -> float:
        """The energy of one slot from ``x0`` at ``lam``: a prepare and one
        trial, run as the loop runs them (replayed on CUDA), to hold the
        loop's trial against an eager one. Leaves the loop ready for
        ``run``."""
        big = dataclasses.replace(self.config, max_iter=2**31 - 1,
                                  max_fun_ev=2**31 - 1)
        # Iteration 2's lambda is the carried one, not the rule's.
        self._init(x0, big, lam=lam, it=1, slot_cap=1)
        self._chunk()
        return self._read(False)[self.pos["e_trial"]]

    def run(self, x0, resume=None, run_log: Optional[RunLog] = None,
            checkpoint_every: int = 0, sync_debug: bool = False,
            config: Optional[LMConfig] = None):
        """The chunked loop from ``x0`` (and ``resume``'s LM scalars), with
        ``config``'s limits (max_iter, max_fun_ev, tol_fun) and debug_nans
        (default: the config the loop was built with; the rest of a config
        is fixed by the capture).
        ``sync_debug`` (CUDA): each chunk runs under
        ``torch.cuda.set_sync_debug_mode("error")``, so that an operation
        that synchronizes there raises; the read after it is outside.
        With ``run_log`` it emits each chunk's rows (Rejected rows
        synthesized from the iteration's lam0 and the growth table, with
        rho None), trace records and the checkpoints due (at the first
        chunk end at or past each multiple of ``checkpoint_every``, JAX
        lm.py:724-736). Returns lm_loop's tuple."""
        cfg, pos = config or self.config, self.pos
        size = cfg.energy_history_size
        it = 0
        if resume:
            it = int(resume.get("iteration", 0))
            self._init(x0, cfg, lam=float(resume.get("lam", math.nan)), it=it,
                       fun_evals=int(resume.get("fun_evals", 0)),
                       hist=resume.get("energy_history", []))
        else:
            self._init(x0, cfg)
        observe = run_log is not None and (
            run_log.verbose or run_log._metrics or run_log.trace is not None
            or run_log.checkpoint_path)
        ckpt = run_log is not None and run_log.checkpoint_path and checkpoint_every
        next_ckpt = (it // checkpoint_every + 1) * checkpoint_every if ckpt else None
        chunk, n_rec = self.config.chunk_size, len(_REC)
        max_iter = min(cfg.max_iter, 2**31 - 1)
        max_fe = min(cfg.max_fun_ev, 2**31 - 1)
        running = float(LMStatus.Running)
        while True:
            t0 = time.perf_counter()
            if sync_debug:
                torch.cuda.set_sync_debug_mode("error")
            self._chunk()
            if sync_debug:
                torch.cuda.set_sync_debug_mode(0)
            vals = self._read(observe)
            wall = time.perf_counter() - t0
            start = int(vals[pos["chunk_start"]])
            it, fun_evals = int(vals[pos["it"]]), int(vals[pos["fun_evals"]])
            status, between = vals[pos["status"]], vals[pos["between"]] > 0
            self.slots += int(vals[pos["slots"]])
            stopped = status != running or it + 1 > max_iter or fun_evals > max_fe
            if not (between and (stopped or it >= start + chunk)):
                raise RuntimeError(
                    f"LM iteration {it}: the chunk ran {int(vals[pos['slots']])} "
                    "trials without ending; lambda does not grow (lambda_"
                    f"increase_base {self.config.lambda_increase_base})")
            if cfg.debug_nans and vals[pos["bad_it"]] > 0:
                raise FloatingPointError(
                    f"LM iteration {int(vals[pos['bad_it']])}: energy "
                    f"{vals[pos['bad_energy']]}, trial energy "
                    f"{vals[pos['bad_e_test']]}, rho denominator "
                    f"{vals[pos['bad_rho_scale']]}")
            hist = vals[pos["hist0"]:pos["hist0"] + size]
            if observe:
                recs = [vals[len(self.sv) + i * n_rec:len(self.sv) + (i + 1) * n_rec]
                        for i in range(it - start)]
                self._emit(run_log, start, recs, wall)
            if next_ckpt is not None and it >= next_ckpt:
                run_log.save(self.x, vals[pos["lam"]], it, fun_evals, hist)
                next_ckpt = (it // checkpoint_every + 1) * checkpoint_every
            if stopped:
                break
        status = LMStatus(int(status))
        if status == LMStatus.Running:
            status = (LMStatus.MaxItersReached if it + 1 > max_iter
                      else LMStatus.TooManyFunctionEvaluation)
            it += 1
        x = _from_leaves(self.x, [t.clone() for t in _leaves(self.x)])
        return x, status, it, fun_evals, vals[pos["energy"]], vals[pos["lam"]]

    def _emit(self, run_log: RunLog, start: int, recs, wall: float) -> None:
        per_trial = wall / max(1, int(sum(r[4] for r in recs)))
        for i, (f, rho, lam0, lam_out, n_trials, accepted, e_out) in enumerate(recs):
            it = start + i + 1
            accepted = accepted > 0
            lam = lam0
            for k in range(int(n_trials) - (1 if accepted else 0)):
                run_log.trial(it, "Rejected", f, None, lam, per_trial,
                              synthesized=True)
                lam *= self.table[min(k, _GROWTH - 1)]
            if accepted:
                run_log.trial(it, "Accepted", f, rho, lam_out, per_trial)
                run_log.traced(it, e_out, lam_out)


#: Captured drives by (device, the caller's problem object, mode, config
#: without its limits), so that warm-up, timed and polish runs reuse one
#: capture. Each entry keeps its problem alive, so its id is not reused.
_GRAPHS: dict = {}
#: What the last jit-drive run did: capture_s (0 where the capture was
#: cached or on the CPU), captured (this run captured), replays (chunks run:
#: graph replays on CUDA), reads (host reads of the LM state), slots (trials
#: run, counted on the device), and the size of the graph cache.
LAST_JIT_RUN: dict = {}


def clear_graphs() -> None:
    """Free every cached jit-drive graph and its memory pool."""
    for _, loop in _GRAPHS.values():
        loop.close()
    _GRAPHS.clear()


def _graph_key(problem, mode, config, x0, dev):
    cfg = dataclasses.replace(config, max_iter=0, max_fun_ev=0, tol_fun=0.0,
                              verbose=False, polish_iters=0, debug_nans=False)
    return (str(dev), id(problem), mode, cfg,
            tuple((t.dtype, tuple(t.shape)) for t in _leaves(x0)))


def _device_loop(problem, mode, config, x0, dev, prepare, trial):
    """(DeviceLoop, capture seconds or 0.0 where cached). ``problem`` is the
    caller's object (the cache key), ``prepare`` and ``trial`` are its step
    functions on ``dev``."""
    if dev.type != "cuda":
        return DeviceLoop(x0, prepare, trial, config, dev), 0.0
    if (schur.MODE_STRATEGY[mode][1] == "qr_cached" and problem.pairs is None):
        raise ValueError(
            "drive='jit' does not run qrkit on a problem without pair tables: "
            "its prepare's torch.linalg.eigh reads its error flag on the host, "
            "which a CUDA graph cannot capture; use drive='host'")
    key = _graph_key(problem, mode, config, x0, dev)
    hit = _GRAPHS.get(key)
    if hit is not None:
        return hit[1], 0.0
    loop = DeviceLoop(x0, prepare, trial, config, dev)
    capture_s = loop.capture(config.use_kernels(dev))
    _GRAPHS[key] = (problem, loop)
    return loop, capture_s



def minimize(problem: problem_mod.BAProblem, mode: str = "cholesky",
             config: Optional[LMConfig] = None,
             state: Optional[problem_mod.BAState] = None,
             device=None, resume=None,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 0,
             metrics_path: Optional[str] = None,
             metrics_phase: Optional[str] = None,
             reduce: schur.Reduce = schur.LOCAL,
             trace: Optional[list] = None) -> LMResult:
    """Run LM on a BA problem on ``device`` (CUDA unless the caller passes
    one, e.g. ``device="cpu"``; without CUDA and without ``device`` it
    raises). The problem and state are moved there first. ``mode`` is one
    of ``schur.MODES`` (cholesky, qrchol, qrkit, moreqr, spqr), the
    reference's five binaries as a runtime argument.

    ``resume`` continues from a checkpoint's meta (``state`` is then the
    checkpoint's state); ``checkpoint_path`` with ``checkpoint_every > 0``
    writes the accepted state every that many iterations; ``metrics_path``
    appends one JSONL record per trial, tagged ``metrics_phase``;
    ``trace``, a list, gets one record per accepted iteration (``RunLog``).

    With ``config.polish_iters`` and a df32 or float32-matmul config, the
    two-phase drive: the fast phase (records tagged "fast") to its own stop
    at max(tol_fun, _POLISH_FAST_TOL), then up to polish_iters float64
    iterations from its endpoint (tagged "polish"; their iterations count
    from 1). The result sums both phases' iterations and evaluations and is
    the polish's, with the fast phase's status where the polish stopped at
    its iteration cap; where the polish cannot evaluate the fast endpoint
    (non-finite energy) the fast phase's result stands.

    ``reduce``: on a shard (``parallel.sharded.minimize_sharded``), the
    problem is the rank's slice and the result's state too; checkpoints
    hold every rank's points and only rank 0 prints and writes.

    ``config.drive == "jit"`` runs the device-resident drive
    (``DeviceLoop``): on CUDA its graph is captured at the first call for
    (problem, mode, config without limits) and replayed by later ones
    (``clear_graphs`` frees them); checkpoints fall at the first chunk end
    at or past each multiple of ``checkpoint_every`` (25 where 0 is given
    with a path), as in JAX's chunked drive. It has no sharded form:
    with a sharded ``reduce`` it raises."""
    schur.check_mode(mode)
    config = config or LMConfig()
    if config.drive not in ("host", "jit"):
        raise ValueError(f"drive must be 'host' or 'jit', got {config.drive!r}")
    if config.drive == "jit" and reduce.sharded:
        raise ValueError(
            "drive='jit' has no sharded form yet (its per-trial all-reduces "
            "would have to be captured into the CUDA graph); run the sharded "
            "path with drive='host'")
    if config.polish_iters and (config.geometry or config.matmul_dtype):
        fast_cfg = dataclasses.replace(
            config, polish_iters=0,
            tol_fun=max(config.tol_fun, _POLISH_FAST_TOL))
        observe = dict(checkpoint_path=checkpoint_path,
                       checkpoint_every=checkpoint_every,
                       metrics_path=metrics_path, reduce=reduce, trace=trace)
        fast = minimize(problem, mode, fast_cfg, state=state, device=device,
                        resume=resume, metrics_phase="fast", **observe)
        polish_cfg = dataclasses.replace(
            config, polish_iters=0, geometry=None, matmul_dtype=None,
            kernels=None, max_iter=config.polish_iters)
        polish = minimize(problem, mode, polish_cfg, state=fast.state,
                          device=device, metrics_phase="polish", **observe)
        counts = dict(iterations=fast.iterations + polish.iterations,
                      fun_evals=fast.fun_evals + polish.fun_evals)
        if not math.isfinite(polish.energy):
            return fast._replace(**counts)
        status = (fast.status if polish.status == LMStatus.MaxItersReached
                  else polish.status)
        return polish._replace(status=status, **counts)

    dev = resolve_device(device)
    given = problem
    problem = problem.to(dev)
    state = problem.state if state is None else state.to(dev)
    prepare, trial, to_loop, to_state = step_functions(problem, mode, config,
                                                       dev, reduce)

    def to_checkpoint(x):
        s = to_state(x)
        return dataclasses.replace(s, points=reduce.points(s.points))

    x0 = to_loop(state)
    capture_s = loop = None
    if config.drive == "jit":
        checkpoint_every = checkpoint_every or (25 if checkpoint_path else 0)
        loop, capture_s = _device_loop(given, mode, config, x0, dev,
                                       prepare, trial)
    with RunLog(config.verbose, metrics_path, metrics_phase, checkpoint_path,
                checkpoint_every, to_checkpoint,
                write=reduce.rank == 0, trace=trace,
                capture_s=capture_s) as run_log:
        if loop is None:
            x, status, it, fun_evals, energy, lam = lm_loop(
                x0, prepare, trial, config, resume=resume, run_log=run_log)
        else:
            loop.reads = loop.replays = loop.slots = 0
            x, status, it, fun_evals, energy, lam = loop.run(
                x0, resume, run_log, checkpoint_every, config=config)
            if loop.graph is not None and config.use_kernels(dev):
                cuda_chain.collect_graph_launches()
            LAST_JIT_RUN.update(
                capture_s=capture_s, captured=capture_s > 0,
                replays=loop.replays, reads=loop.reads, slots=loop.slots,
                graphs_cached=len(_GRAPHS))
    return LMResult(state=to_state(x), status=status, iterations=it,
                    fun_evals=fun_evals, energy=energy, lam=lam)

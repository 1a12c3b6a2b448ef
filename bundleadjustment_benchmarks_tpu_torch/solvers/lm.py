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
drive, ``cuda_chain.blocks_energy_f64`` on the float64 drive on CUDA) and
then damping ``trial``s (the reduced solve, the manifold step and the trial
energy, ``cuda_chain.fused_energy`` on the df32 drive,
``cuda_chain.energy_f64`` on the float64 drive on CUDA). Two drives
run that control flow (``LMConfig.drive``):

  * "jit" (``DeviceLoop``, the default, as in the JAX package, and
    bench.py's drive, JAX lm.py:286-786): the LM scalars are float64 device
    tensors and every decision is taken on the device; on CUDA the loop of
    damping trials with its control flow is captured once into a CUDA graph
    with conditional nodes (``ops/cuda_graph.py``) and replayed. A run that
    nothing observes is one replay and one host read at its end (JAX's one
    ``_minimize_jit`` dispatch); an observed or ``chunked`` one replays the
    graph once per chunk of ``chunk_size`` iterations and reads the state
    after each, and its table, JSONL records and checkpoints follow JAX's
    chunked drive. The graph is cached for the problem (``_device_loop``).
  * "host" (``lm_loop``; the command line's default, as JAX's): plain
    Python over device-resident tensors. The host reads the trial energy
    and rho's denominator once per trial (with the outer energy on the
    first trial) for the accept test, and a float32 Cholesky camera solve
    reads its breakdown flag once. LM scalars are Python floats (float64).
    Same arithmetic as the jit drive: on one device the two give the same
    LM path.

The loop also carries the host drive's observability (JAX lm.py:792-939):
the reference's per-trial iteration table (``LMConfig.verbose``), one JSONL
metrics record per trial, checkpoints of the accepted state and resuming
from one (``utils/checkpoint.py``), all from the values the trial's one host
read already brought back. ``LMConfig.polish_iters`` runs the two-phase
drive: the df32 descent, then a float64 polish from its endpoint.

The sharded path (``parallel/sharded.py``) runs this same loop on each
rank's slice of the points, with a ``schur.Reduce`` that all-reduces the
partial sums: every rank reads the same trial scalars and so takes the same
decisions. On the jit drive the all-reduces are captured into the graph
(NCCL on CUDA) and every predicate derives from all-reduced values, so the
ranks take the same branches without a host read.
"""

from __future__ import annotations

import dataclasses
import enum
import gc
import json
import math
import time
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from bundleadjustment_benchmarks_tpu_torch import resolve_device
from bundleadjustment_benchmarks_tpu_torch.models import problem as problem_mod
from bundleadjustment_benchmarks_tpu_torch.ops import (cuda_chain, cuda_eigh, cuda_graph, jacobian,
                                                       projection)
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
    #: Run the chain through the CUDA kernels (ops/cuda_chain.py): the df32
    #: drive's, or the float64 drive's where matmul_dtype is None and the
    #: state is float64. None = exactly when the device is CUDA and the drive
    #: has kernels; True off CUDA raises; False on CUDA is for
    #: kernel-vs-plain checks.
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
    #: "jit", the default as in JAX (JAX lm.py:92), and bench.py's drive:
    #: the device-resident drive (``DeviceLoop``); on CUDA every prepare and
    #: trial runs from one captured CUDA graph with conditional nodes, and
    #: the host reads the LM scalars once a run (once per chunk where the
    #: run is observed or ``chunked``). "host": the Python loop, one host
    #: read per trial (``lm_loop``).
    drive: str = "jit"
    #: Outer iterations per host read of the jit drive where it runs in
    #: chunks (JAX lm.py:139-143).
    chunk_size: int = 16
    #: Run the jit drive in chunks of ``chunk_size`` iterations even where
    #: nothing observes the run (JAX lm.py:150-157): a host read after each
    #: chunk. False, the default as in JAX: a run without ``verbose``, a
    #: checkpoint, metrics, ``resume``, a ``trace`` or ``records`` is one
    #: dispatch (one graph replay on CUDA) and one host read at its end.
    #: Ignored on a shard, as JAX's ``minimize_sharded`` ignores it.
    chunked: bool = False

    def use_kernels(self, device: torch.device,
                    dtype: torch.dtype = torch.float64) -> bool:
        """Whether the chain runs through the kernels on ``device`` for a
        state of ``dtype``: the df32 drive's pair, or the float64 drive's
        where geometry and matmul_dtype are None and ``dtype`` is float64."""
        if self.kernels and device.type != "cuda":
            raise ValueError(
                f"LMConfig(kernels=True) needs a CUDA device, got {device}")
        if self.geometry != "df32" and (self.geometry is not None
                                        or self.matmul_dtype is not None
                                        or dtype != torch.float64):
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
             reduce: schur.Reduce = schur.LOCAL, kernels: bool = False):
    """Residuals, Jacobian, energy and the Schur context (state geometry).
    Returns (ctx, float64 energy, float64 lambda0). On a shard (``reduce``)
    the energy and the camera totals cover every rank. ``kernels=True``
    runs the residual/Jacobian/energy chain as one float64 CUDA kernel
    launch (the plain path's math; float64, no matmul_dtype)."""
    mm = _mm(matmul_dtype)
    if kernels:
        blocks, energy = cuda_chain.blocks_energy_f64(state, problem.obs,
                                                      problem.tau2)
    else:
        blocks = jacobian.residuals_and_jacobian(
            state, problem.obs, problem.tau2, compute_dtype=mm)
        energy = projection.compensated_square_sum(blocks.f)
    (energy,) = reduce.sum(energy)
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
           reduce: schur.Reduce = schur.LOCAL, kernels: bool = False):
    """One damping trial: solve, step, trial energy, rho's denominator.
    ``kernels=True`` computes the trial energy in one float64 CUDA kernel
    launch."""
    mm = _mm(matmul_dtype)
    dxp, dxc = _solve(ctx, lam, problem, mode, mm, refine, reduce)
    x_test = problem_mod.apply_step(state, dxp, dxc)
    if kernels:
        e_test = cuda_chain.energy_f64(x_test, problem.obs, problem.tau2)
    else:
        e_test = projection.energy(x_test, problem.obs, problem.tau2,
                                   compute_dtype=mm)
    (e_test,) = reduce.sum(e_test)
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
    kernels = config.use_kernels(torch.device(device), problem.state.T.dtype)
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
        return _prepare(x, problem, mode, mm, reduce, kernels)

    def trial(ctx, x, lam):
        return _trial(ctx, x, lam, problem, mode, mm, refine, reduce, kernels)

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
    lambda after the update, and phase when set), and one ``IterRecord``
    per iteration appended to ``records``, from the run's first iteration
    on (a two-phase run appends both phases'), and ``states``, a callable,
    called after every iteration with the iteration's number, a copy of
    the loop state after it as a float64 BAState (``_float64_state``) and
    its ``IterRecord``. ``to_state`` maps the
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
                 capture_s: Optional[float] = None,
                 records: Optional[list] = None, states=None):
        self.verbose = verbose and write
        self.metrics_path = metrics_path if write else None
        self.phase = phase
        self.checkpoint_path = checkpoint_path if checkpoint_every else None
        self.checkpoint_every = checkpoint_every
        self.to_state = to_state
        self.write = write
        self.trace = trace
        self.records = records
        self.states = states
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

    def iteration(self, record: "IterRecord") -> None:
        if self.records is not None:
            self.records.append(record)

    def observed(self, it: int, x, record: "IterRecord") -> None:
        """Hand ``states`` the loop state ``x`` after iteration ``it``."""
        if self.states is not None:
            self.states(it, _float64_state(x), record)

    def save(self, x, lam: float, it: int, fun_evals: int, hist) -> None:
        """Checkpoint ``x`` (the loop state) with the LM scalars."""
        from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint

        state = self.to_state(x)
        if self.write:
            checkpoint.save_checkpoint(
                self.checkpoint_path, state, lam=lam, iteration=it,
                fun_evals=fun_evals, energy_history=list(hist))


class IterRecord(NamedTuple):
    """One outer iteration as both drives record it (JAX's _IterRecord,
    JAX lm.py:301-311, with the energy it ended at): the prepare's energy
    ``f``, the last trial's gain ratio ``rho``, the first trial's lambda
    ``lam0``, lambda after the accept or the last reject ``lam_out``, the
    trials run, whether the last was accepted, and ``energy_out``: the
    accepted trial's energy, else ``f``."""

    f: float
    rho: float
    lam0: float
    lam_out: float
    n_trials: int
    accepted: bool
    energy_out: float


def _nielsen(rho):
    """Lambda's factor on an accepted trial, max(1/3, 1 - (2 rho - 1)^3)
    (BacktrackLevMarqCholesky.h:303): of a float on the host drive, of a
    device tensor on the jit drive (where a NaN rho stays NaN, as under
    JAX's ``jnp.maximum``)."""
    t = 2.0 * rho - 1.0
    factor = 1.0 - t * (t * t)
    if isinstance(factor, torch.Tensor):
        return torch.clamp(factor, min=1.0 / 3.0)
    return max(1.0 / 3.0, factor)


def lm_loop(x0, prepare, trial, config: LMConfig, resume=None,
            run_log: Optional[RunLog] = None):
    """The LM control flow around ``prepare(x) -> (ctx, energy, lam0)`` and
    ``trial(ctx, x, lam) -> (x_test, e_test, rho_scale)``.

    ``resume``: a checkpoint's meta (``utils.checkpoint.load_checkpoint``):
    lambda, iteration, fun_evals and the energy history continue from it,
    and the first-iteration lambda rule is skipped. ``run_log`` gets every
    trial's row (Elapsed: the host clock after the trial's one host read,
    from the start of the iteration or of the previous rejected trial),
    every iteration's ``IterRecord``, every accepted state and the state
    after every iteration (``RunLog.observed``). Lambda
    grows by ``growth_table``'s factors, as on the jit drive.

    Returns (x, status, iterations, fun_evals, energy, lam) with the
    reference's bookkeeping: a run stopped by max_iter or max_fun_ev counts
    the iteration that found the limit."""
    x = x0
    lam = math.nan  # set from the first prepare's schur.initial_lambda
    growth = growth_table(config.lambda_increase_base)
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
        ctx, energy_t, lam_rule = prepare(x)
        fun_evals += 1
        if it == 1 and not resume:
            lam = float(lam_rule)
        lam0, trials = lam, 0
        while True:
            x_t, e_t, rho_scale = trial(ctx, x, lam)
            trials += 1
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
                lam = max(lam * _nielsen(rho), config.lambda_min)
                if run_log:
                    run_log.trial(it, "Accepted", energy, rho, lam, elapsed)
                    record = IterRecord(energy, rho, lam0, lam, trials, True, e_t)
                    run_log.iteration(record)
                energy = e_t
                hist[it % size] = energy
                break
            if run_log:
                run_log.trial(it, "Rejected", energy, 0.0, lam, elapsed)
            if lam > config.lambda_max or not (
                    math.isfinite(lam) and math.isfinite(energy)):
                status = LMStatus.ExceededLambdaMax
                if run_log:
                    # The jit drive's rho of the last trial: IEEE division.
                    rho = (torch.tensor(energy - e_t, dtype=torch.float64)
                           / rho_scale).item()
                    record = IterRecord(energy, rho, lam0, lam, trials, False,
                                        energy)
                    run_log.iteration(record)
                break
            lam *= growth[min(trials - 1, _GROWTH - 1)]
            t0 = time.perf_counter()
        if status == LMStatus.Running:
            if run_log:
                run_log.accepted(it, x_t, lam, fun_evals, hist)
            if it > size and abs(energy - max(hist)) < config.tol_fun * energy:
                status = LMStatus.Success
                if not config.discard_final_step:
                    x = x_t
            else:
                x = x_t
        if run_log:
            run_log.observed(it, x, record)
        if status != LMStatus.Running:
            break
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
#: host sets: the chunk's length in iterations, the cap on an iteration's
#: trials, and the limits (JAX's traced _Limits). Changing any of these
#: does not recapture.
_DYN = ("lam", "it", "fun_evals", "status", "energy", "between", "f", "lam0",
        "trials", "e_trial", "slots", "bad_it", "bad_energy", "bad_e_test",
        "bad_rho_scale", "chunk_start", "chunk_end")
_HOST = ("chunk_len", "trial_cap", "max_iter", "max_fun_ev", "tol_fun")
#: The entries that an iteration's start and a trial write (a trial also
#: writes the flatline history).
_BEGIN_SET = ("it", "fun_evals", "f", "lam", "lam0", "trials", "between")
_STEP_SET = ("lam", "fun_evals", "trials", "between", "status", "energy",
             "e_trial", "slots", "bad_it", "bad_energy", "bad_e_test",
             "bad_rho_scale")
#: The columns of the device's record of each outer iteration, an
#: ``IterRecord`` (JAX's _IterRecord without its lam_inc0, which is always
#: lambda_increase_base since lam_inc resets at every accept): enough to
#: rebuild every trial's table row.
_REC = IterRecord._fields
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


def _float64_state(x) -> problem_mod.BAState:
    """A copy of loop state ``x`` as a float64 BAState: a df32 state's
    points are its DF pairs summed in float64, exactly."""
    x = _from_leaves(x, [t.clone() for t in _leaves(x)])
    if isinstance(x, problem_mod.FastBAState):
        return problem_mod.from_fast(x, dtype=torch.float64)
    return _from_leaves(x, [t.to(torch.float64) for t in _leaves(x)])


def _as_record(row) -> IterRecord:
    """A row of the device's iteration record as an ``IterRecord``."""
    f, rho, lam0, lam_out, n_trials, accepted, e_out = row
    return IterRecord(f, rho, lam0, lam_out, int(n_trials), accepted > 0, e_out)


def growth_table(base: float) -> list:
    """lam_inc after 0, 1, ... rejects: ``base``, then ``lam_inc ** 1.5``
    (BacktrackLevMarqCholesky.h:331-334), in Python floats, saturating at
    inf. Both drives grow lambda by it, so they agree bit for bit."""
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
    is ``growth_table``'s n-th entry, as on the host drive.

    On CUDA the chunk is captured once into a ``cuda_graph.DeviceGraph``
    (its loop of slots, their two branches and the float32 Cholesky's
    fallback are conditional nodes) and ``run`` replays it; on the CPU
    ``run`` calls it. Either way the host reads the state once per chunk.
    The chunk's length is a device value (``chunk_len``, set by ``run``):
    ``config.chunk_size`` outer iterations for a chunked run, ``max_iter``
    for an unchunked one, which so runs as one chunk, one replay and one
    read (JAX's single ``_minimize_jit`` dispatch); one capture serves both.
    An iteration stops after ``_GROWTH + 1`` trials, as many as it can take
    where lambda grows (the growth table reaches inf by its last entry for
    any base above 1, and a rejected trial at an infinite lambda stops the
    run); ``run`` raises if that cap ended a chunk, where the host drive
    would loop forever, on either route.

    On a shard (``reduce``, a sharded ``schur.Reduce``) ``prepare`` and
    ``trial`` hold collectives, which the capture records into the graph:
    the IF body of an iteration's start and the loop body of its trials.
    ``collectives`` keeps the calls and bytes of the last prepare and the
    last trial that Python ran (the capture's on CUDA, where a replay runs
    no Python), which times ``prepares`` and ``slots`` give a run's
    collectives. Torch's NCCL watchdog does not see work in a replay, so
    no collective timeout bounds it: a rank that hangs there holds the
    others at the chunk's read, and only the caller's deadline (a
    ``multihost.run_ranks`` ``deadline``, a job's limit) ends the run. An
    unchunked run reads once, at its end, so that deadline is the only
    bound on the whole run.

    Every prepare and every trial is a span of the device's in-graph record
    (``cuda_graph.mark``; the reduced camera solve and the pair gram inside
    a trial are two more), zeroed by ``run`` and brought back by each read with the state:
    ``marks`` holds the last read's totals and counts
    (``cuda_graph.unpack``). The host's steps are ``torch.profiler``
    ranges: ``ba.warmup`` and ``ba.capture`` in ``capture``, ``ba.replay``
    and ``ba.read`` per chunk."""

    def __init__(self, x0, prepare, trial, config: LMConfig, device,
                 reduce: schur.Reduce = schur.LOCAL):
        self.config = config
        self.device = torch.device(device)
        self.prepare, self.trial = prepare, trial
        self.reduce = reduce
        self.collectives: dict = {}
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
        self.warmup_s = 0.0
        self.reads = self.replays = self.slots = self.prepares = 0
        self.chunked = False
        # The part of the in-graph record each read brings back.
        self.marked = cuda_graph.readable(self.device)
        self.marks: dict = {}

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
        self.sv[self.pos["chunk_end"]].copy_(v("it") + v("chunk_len"))
        self.sv[self.pos["slots"]].zero_()
        cuda_graph.device_while(self._live, self._slot)

    def _live(self):
        v = self._v
        between = v("between") > 0
        may_start = ((v("it") + 1 <= v("max_iter"))
                     & (v("fun_evals") <= v("max_fun_ev"))
                     & (v("it") < v("chunk_end")))
        return ((v("status") == float(LMStatus.Running))
                & (~between | may_start)
                & (between | (v("trials") < v("trial_cap"))))

    def _slot(self):
        cuda_graph.device_if(self._v("between") > 0, self._begin)
        self._step()

    def _tallied(self, which: str, fn, *args):
        """``fn(*args)``, noting the collectives it issued as ``which``."""
        r = self.reduce
        if not r.sharded:
            return fn(*args)
        calls, nbytes = r.calls, r.bytes
        out = fn(*args)
        self.collectives[which] = {"calls": r.calls - calls,
                                   "bytes": r.bytes - nbytes}
        return out

    def _begin(self):
        v = self._v
        cuda_graph.mark(self.device, "prepare_begin")
        self.ctx, energy, lam0_rule = self._tallied("prepare", self.prepare,
                                                    self.x)
        it = v("it") + 1
        lam0 = torch.where(it == 1, lam0_rule.to(torch.float64), v("lam"))
        zero = self.sv.new_zeros(())
        self._write("begin", (it, v("fun_evals") + 1, energy, lam0, lam0, zero,
                              zero))
        cuda_graph.mark(self.device, "prepare_end")

    def _step(self):
        v, cfg, f64 = self._v, self.config, torch.float64
        lam, f, it, trials = v("lam"), v("f"), v("it"), v("trials")
        cuda_graph.mark(self.device, "trial_begin")
        x_t, e_t, rho_scale = self._tallied("trial", self.trial, self.ctx,
                                            self.x, lam)
        cuda_graph.mark(self.device, "trial_end")
        e_t, rho_scale = e_t.to(f64), rho_scale.to(f64)
        lam_inc = torch.index_select(
            self.table_dev, 0,
            trials.to(torch.int64).clamp(max=_GROWTH - 1).view(1)).view(())
        accepted = e_t < f
        # Accept: Nielsen decrease (BacktrackLevMarqCholesky.h:299-316).
        rho = (f - e_t) / rho_scale
        lam_acc = torch.clamp(lam * _nielsen(rho), min=cfg.lambda_min)
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
        workspaces, the chain kernels' workspace, the in-graph record, the
        per-device index tables; on a shard the NCCL communicator and its
        stream, which must not start inside a capture). Returns the
        capture's seconds, warm-up excluded; ``warmup_s`` keeps the
        warm-up's. A failed capture raises."""
        graph = cuda_graph.DeviceGraph(self.device)
        t0 = time.perf_counter()
        with record_function("ba.warmup"), torch.cuda.stream(graph.stream):
            if kernels:
                cuda_chain.prepare_capture(self.device)
            ctx, _, lam0 = self.prepare(self.x)
            self.trial(ctx, self.x, lam0.to(torch.float64))
            del ctx
            torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        # The warm-up's memory goes back to the device before the graph's
        # pool takes its own.
        torch.cuda.empty_cache()
        with record_function("ba.capture"):
            graph.capture(self.chunk)
        self.graph = graph
        return graph.capture_s

    def close(self) -> None:
        if self.graph is not None:
            self.graph.close()
            self.graph = None
        self.ctx = None

    def _init(self, x0, cfg: LMConfig, lam=math.nan, it=0, fun_evals=0,
              hist=(), chunk_len=None, trial_cap=_GROWTH + 1) -> None:
        """Copy ``x0`` into the loop's state and set the LM scalars: those
        given (a fresh run's or a checkpoint's), the chunk's length
        (default ``chunk_size``), the cap on an iteration's trials, and
        ``cfg``'s limits."""
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
        init[pos["chunk_len"]] = self.config.chunk_size if chunk_len is None else chunk_len
        init[pos["trial_cap"]] = trial_cap
        init[pos["max_iter"]] = min(cfg.max_iter, i32max)
        init[pos["max_fun_ev"]] = min(cfg.max_fun_ev, i32max)
        init[pos["tol_fun"]] = cfg.tol_fun
        self.sv.copy_(torch.tensor(init, dtype=torch.float64))
        cuda_graph.zero_marks(self.device)

    def _chunk(self) -> None:
        with record_function("ba.replay"):
            (self.graph.replay if self.graph is not None else self.chunk)()
        self.replays += 1

    def _read(self, observe: bool) -> list:
        """The state vector (and with ``observe`` the iteration records
        after it), in one host read that also brings back the in-graph
        record into ``marks``."""
        self.reads += 1
        n, m = len(self.sv), len(self.marked)
        with record_function("ba.read"):
            parts = [self.sv, self.marked.to(torch.float64)]
            if observe:
                parts.append(self.rec.view(-1))
            vals = torch.cat(parts).tolist()
        self.marks = cuda_graph.unpack(vals[n:n + m])
        return vals[:n] + vals[n + m:]

    def first_trial(self, x0, lam: float) -> float:
        """The energy of one slot from ``x0`` at ``lam``: a prepare and one
        trial, run as the loop runs them (replayed on CUDA), to hold the
        loop's trial against an eager one. Leaves the loop ready for
        ``run``."""
        big = dataclasses.replace(self.config, max_iter=2**31 - 1,
                                  max_fun_ev=2**31 - 1)
        # Iteration 2's lambda is the carried one, not the rule's.
        self._init(x0, big, lam=lam, it=1, chunk_len=1, trial_cap=1)
        self._chunk()
        return self._read(False)[self.pos["e_trial"]]

    def run(self, x0, resume=None, run_log: Optional[RunLog] = None,
            checkpoint_every: int = 0, sync_debug: bool = False,
            config: Optional[LMConfig] = None):
        """The loop from ``x0`` (and ``resume``'s LM scalars), with
        ``config``'s limits (max_iter, max_fun_ev, tol_fun), debug_nans and
        chunked (default: the config the loop was built with; the rest of a
        config is fixed by the capture). It routes as JAX's ``minimize``:
        in chunks of ``chunk_size`` iterations where ``run_log`` observes
        the run (verbose, metrics, checkpoints, a trace, records; of one
        iteration where ``states`` observes it), where it
        resumes or where ``chunked`` is set, else as one chunk of
        ``max_iter``. On a shard ``chunked`` is ignored, as JAX's
        ``minimize_sharded`` has no chunks (``self.chunked`` says which
        route the run took).
        ``sync_debug`` (CUDA): each chunk runs under
        ``torch.cuda.set_sync_debug_mode("error")``, so that an operation
        that synchronizes there raises; the read after it is outside.
        With ``run_log`` it emits each chunk's rows (Rejected rows
        synthesized from the iteration's lam0 and the growth table, with
        rho None), its iteration records as the device wrote them, trace
        records and the checkpoints due (at the first chunk end at or past
        each multiple of ``checkpoint_every``, JAX lm.py:724-736). Returns
        lm_loop's tuple."""
        cfg, pos = config or self.config, self.pos
        size = cfg.energy_history_size
        max_iter = min(cfg.max_iter, 2**31 - 1)
        observe = run_log is not None and bool(
            run_log.verbose or run_log._metrics or run_log.trace is not None
            or run_log.records is not None or run_log.checkpoint_path
            or run_log.states is not None)
        self.chunked = observe or bool(resume) or (
            cfg.chunked and not self.reduce.sharded)
        chunk = self.config.chunk_size if self.chunked else max_iter
        if observe and run_log.states is not None:
            chunk = 1
        it = 0
        if resume:
            it = int(resume.get("iteration", 0))
            self._init(x0, cfg, lam=float(resume.get("lam", math.nan)), it=it,
                       fun_evals=int(resume.get("fun_evals", 0)),
                       hist=resume.get("energy_history", []), chunk_len=chunk)
        else:
            self._init(x0, cfg, chunk_len=chunk)
        ckpt = run_log is not None and run_log.checkpoint_path and checkpoint_every
        next_ckpt = (it // checkpoint_every + 1) * checkpoint_every if ckpt else None
        n_rec = len(_REC)
        max_fe = min(cfg.max_fun_ev, 2**31 - 1)
        running = float(LMStatus.Running)
        fun_evals = int(resume.get("fun_evals", 0)) if resume else 0
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
            before, slots = fun_evals, int(vals[pos["slots"]])
            it, fun_evals = int(vals[pos["it"]]), int(vals[pos["fun_evals"]])
            status, between = vals[pos["status"]], vals[pos["between"]] > 0
            self.slots += slots
            self.prepares += fun_evals - before - slots
            stopped = status != running or it + 1 > max_iter or fun_evals > max_fe
            if not (between and (stopped or it >= start + chunk)):
                raise RuntimeError(
                    f"LM iteration {it}: the iteration ran {int(vals[pos['trials']])} "
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
                if recs:
                    run_log.observed(it, self.x, _as_record(recs[-1]))
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
        for i, row in enumerate(recs):
            it = start + i + 1
            record = _as_record(row)
            f, rho, lam0, lam_out, n_trials, accepted, e_out = record
            run_log.iteration(record)
            lam = lam0
            for k in range(n_trials - (1 if accepted else 0)):
                run_log.trial(it, "Rejected", f, None, lam, per_trial,
                              synthesized=True)
                lam *= self.table[min(k, _GROWTH - 1)]
            if accepted:
                run_log.trial(it, "Accepted", f, rho, lam_out, per_trial)
                run_log.traced(it, e_out, lam_out)


#: Captured drives by (device, the caller's problem object, mode, config
#: without its limits, the reduce's capture key), so that warm-up, timed
#: and polish runs reuse one capture. Each entry keeps its problem alive,
#: so its id is not reused. The cache holds the captures of one problem per
#: device and group: capturing another problem's frees the older problem's
#: entries (``_device_loop``).
_GRAPHS: dict = {}
#: What the last jit-drive run did (``minimize``'s docstring lists the
#: entries).
LAST_JIT_RUN: dict = {}


def clear_graphs(sharded_only: bool = False) -> None:
    """Free the cached jit-drive graphs and their memory pools: all, or
    those that hold collectives. Free the latter before their process group
    is destroyed (``multihost.run_ranks`` does)."""
    _free([key for key in _GRAPHS if key[-1] is not None or not sharded_only])


def _free(keys) -> None:
    """Close the graphs of ``keys`` and hand their pools back to the device."""
    if not keys:
        return
    for key in keys:
        _GRAPHS.pop(key)[1].close()
    gc.collect()  # a loop's tensors in reference cycles hold pool blocks
    torch.cuda.empty_cache()


def _free_other_problems(key, problem) -> None:
    """Free the cached captures of every problem but ``problem`` on the
    device and group of ``key`` (a ``_graph_key``)."""
    _free([k for k, (p, _) in _GRAPHS.items()
           if k[0] == key[0] and k[-1] == key[-1] and p is not problem])


def _graph_key(problem, mode, config, x0, dev, reduce=schur.LOCAL):
    cfg = dataclasses.replace(config, max_iter=0, max_fun_ev=0, tol_fun=0.0,
                              verbose=False, polish_iters=0, debug_nans=False,
                              chunked=False)
    return (str(dev), id(problem), mode, cfg,
            tuple((t.dtype, tuple(t.shape)) for t in _leaves(x0)),
            reduce.capture_key())


def _device_loop(problem, mode, config, x0, dev, prepare, trial,
                 reduce: schur.Reduce = schur.LOCAL):
    """(DeviceLoop, capture seconds or 0.0 where cached). ``problem`` is the
    caller's object (the cache key), ``prepare`` and ``trial`` are its step
    functions on ``dev`` with ``reduce``.

    A capture for one problem frees the cached captures of every other
    problem on the same device and group (the Ladybug stand-in's pool holds
    11.62 GB on an H100), so a process that minimizes problems in turn
    holds one problem's pools, one for each mode and config it runs on
    that problem. The entries are not freed when their problem is
    collected instead: the cached loop's step functions hold the problem,
    so a weak reference to it would never die while the cache holds the
    loop."""
    if dev.type != "cuda":
        return DeviceLoop(x0, prepare, trial, config, dev, reduce), 0.0
    reduce.check_capture(dev)
    key = _graph_key(problem, mode, config, x0, dev, reduce)
    hit = _GRAPHS.get(key)
    if hit is not None:
        return hit[1], 0.0
    _free_other_problems(key, problem)
    loop = DeviceLoop(x0, prepare, trial, config, dev, reduce)
    capture_s = loop.capture(config.use_kernels(dev, problem.state.T.dtype))
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
             trace: Optional[list] = None,
             records: Optional[list] = None, states=None) -> LMResult:
    """Run LM on a BA problem on ``device`` (CUDA unless the caller passes
    one, e.g. ``device="cpu"``; without CUDA and without ``device`` it
    raises). The problem and state are moved there first. ``mode`` is one
    of ``schur.MODES`` (cholesky, qrchol, qrkit, moreqr, spqr), the
    reference's five binaries as a runtime argument.

    ``resume`` continues from a checkpoint's meta (``state`` is then the
    checkpoint's state); ``checkpoint_path`` with ``checkpoint_every > 0``
    writes the accepted state every that many iterations; ``metrics_path``
    appends one JSONL record per trial, tagged ``metrics_phase``;
    ``trace``, a list, gets one record per accepted iteration, and
    ``records``, a list, one ``IterRecord`` per iteration, and ``states``,
    a callable, (iteration, a float64 copy of the state after it, its
    ``IterRecord``) after every iteration (``RunLog``; on a shard the
    rank's points): the port's own observer, for ``bench_torch.py``'s
    gate (e), with no counterpart in the JAX package.

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

    ``config.drive == "jit"`` (the default) runs the device-resident drive
    (``DeviceLoop``): on CUDA its graph is captured at the first call for
    (problem, mode, config without limits, the reduce's group) and replayed
    by later ones, until a capture for another problem on the device frees
    it (``_device_loop``; ``clear_graphs`` frees all). It routes as the JAX
    package's ``minimize``: a run with ``config.verbose``,
    ``checkpoint_path``, ``metrics_path``, ``resume``, ``trace``,
    ``records`` or ``config.chunked`` runs in chunks of ``chunk_size``
    iterations (of one where ``states`` observes it: the same graph, a
    replay and a read per iteration), a host read after each (JAX's
    ``chunked_loop``; checkpoints
    fall at the first chunk end at or past each multiple of
    ``checkpoint_every``, 25 where 0 is given with a path); any other is
    one replay and one read. On a shard
    it routes as the JAX package's ``minimize_sharded``: a run with
    ``checkpoint_path``, ``metrics_path`` or ``resume`` takes the host
    drive, any other the device loop with its collectives captured (NCCL on
    CUDA; a gloo group on CUDA raises) and, like JAX's ``lm_loop``, no
    iteration table: one dispatch, or chunks where a ``trace`` or
    ``records`` asks (``config.chunked`` is ignored there: JAX's sharded
    drive has no chunks). A collective in a replay has no timeout of its
    own (see ``DeviceLoop``).

    After a jit-drive run ``LAST_JIT_RUN`` says what it did:

    * ``capture_s``: the capture's seconds, its eager warm-up excluded, and
      ``warmup_s`` the warm-up's (both 0 where the capture was cached or on
      the CPU); ``captured``: this run captured;
    * ``chunked``: it ran in chunks of ``chunk_size`` (else as one);
      ``replays``: chunks run (graph replays on CUDA); ``reads``: host reads
      of the LM state, one a chunk;
    * ``slots``: trials run and ``prepares``: iterations started, both
      counted on the device;
    * ``device_s``: {"prepare", "trial", "camera_solve", "pair_gram"}, the
      seconds each span took in all, by the device's clock between its
      in-graph marks (the host's on the CPU), and ``span_counts`` the count
      of each: ``prepares``, ``slots``, ``slots`` (a trial holds one camera
      solve; with ``refine_steps`` one more per pass) and, where the mode
      sums the reduced system from the problem's pair tables (cholesky,
      qrchol, moreqr, qrkit), ``slots`` (else 0);
      ``camera_fallbacks``: camera solves (float32 or float64) whose
      Cholesky broke down and took the fallback; all brought back by
      the reads above;
    * ``graphs_cached``: the size of the graph cache;
    * on a shard, the collectives: ``allreduce_per_prepare`` and
      ``allreduce_per_trial`` ({"calls", "bytes"} of one, from the capture
      on CUDA) and their totals over the run, ``allreduce_calls`` and
      ``allreduce_bytes``.

    The host's steps are ``torch.profiler`` ranges on the profiler's clock,
    beside the device's operations and marks: ``ba.enter`` (the move to the
    device, ``step_functions``, the loop state), ``ba.warmup`` and
    ``ba.capture`` where the run captures, ``ba.replay`` and ``ba.read``
    per chunk."""
    schur.check_mode(mode)
    config = config or LMConfig()
    if config.drive not in ("host", "jit"):
        raise ValueError(f"drive must be 'host' or 'jit', got {config.drive!r}")
    if config.polish_iters and (config.geometry or config.matmul_dtype):
        fast_cfg = dataclasses.replace(
            config, polish_iters=0,
            tol_fun=max(config.tol_fun, _POLISH_FAST_TOL))
        observe = dict(checkpoint_path=checkpoint_path,
                       checkpoint_every=checkpoint_every,
                       metrics_path=metrics_path, reduce=reduce, trace=trace,
                       records=records, states=states)
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
    with record_function("ba.enter"):
        problem = problem.to(dev)
        state = problem.state if state is None else state.to(dev)
        prepare, trial, to_loop, to_state = step_functions(problem, mode, config,
                                                           dev, reduce)
        x0 = to_loop(state)

    def to_checkpoint(x):
        s = to_state(x)
        return dataclasses.replace(s, points=reduce.points(s.points))

    capture_s = loop = None
    verbose = config.verbose
    observed = bool(checkpoint_path or metrics_path or resume)
    if config.drive == "jit" and not (reduce.sharded and observed):
        checkpoint_every = checkpoint_every or (25 if checkpoint_path else 0)
        loop, capture_s = _device_loop(given, mode, config, x0, dev,
                                       prepare, trial, reduce)
        # The sharded device loop, like JAX's lm_loop, prints no table.
        verbose = verbose and not reduce.sharded
    with RunLog(verbose, metrics_path, metrics_phase, checkpoint_path,
                checkpoint_every, to_checkpoint,
                write=reduce.rank == 0, trace=trace,
                capture_s=None if reduce.sharded else capture_s,
                records=records, states=states) as run_log:
        if loop is None:
            x, status, it, fun_evals, energy, lam = lm_loop(
                x0, prepare, trial, config, resume=resume, run_log=run_log)
        else:
            loop.reads = loop.replays = loop.slots = loop.prepares = 0
            x, status, it, fun_evals, energy, lam = loop.run(
                x0, resume, run_log, checkpoint_every, config=config)
            marks = loop.marks
            if loop.graph is not None:
                # The launch counters came back with the last read.
                cuda_chain.credit_graph_launches(dev, marks)
                cuda_eigh.credit_graph_launches(dev, marks["jacobi_eigh"])
            LAST_JIT_RUN.clear()
            LAST_JIT_RUN.update(
                capture_s=capture_s, captured=capture_s > 0,
                warmup_s=loop.warmup_s if capture_s > 0 else 0.0,
                chunked=loop.chunked, replays=loop.replays, reads=loop.reads,
                slots=loop.slots, prepares=loop.prepares,
                device_s=marks["device_s"], span_counts=marks["span_counts"],
                camera_fallbacks=marks["camera_fallback"],
                graphs_cached=len(_GRAPHS))
            if reduce.sharded:
                per = {k: loop.collectives.get(k, {"calls": 0, "bytes": 0})
                       for k in ("prepare", "trial")}
                LAST_JIT_RUN.update(
                    allreduce_per_prepare=per["prepare"],
                    allreduce_per_trial=per["trial"],
                    **{f"allreduce_{k}": per["prepare"][k] * loop.prepares
                       + per["trial"][k] * loop.slots for k in ("calls", "bytes")})
    return LMResult(state=to_state(x), status=status, iterations=it,
                    fun_evals=fun_evals, energy=energy, lam=lam)

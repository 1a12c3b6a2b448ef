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
the trial energy, ``cuda_chain.fused_energy`` on the df32 drive). The loop is
plain Python over device-resident tensors: the host reads the trial energy
and rho's denominator once per trial (with the outer energy on the first
trial) for the accept test, a float32 Cholesky camera solve reads its
breakdown flag once, and qrkit's prepare on a problem without pair tables
reads the error flag of its one ``torch.linalg.eigh``. LM scalars (lambda, nu, energies)
are Python floats, i.e. float64, whatever the state's dtype.

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
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, jacobian, projection
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


def _solve(ctx, lam: float, problem, mode: str, mm, refine: int,
           reduce: schur.Reduce = schur.LOCAL):
    """The damped step and ``refine`` refinement passes on it."""
    dxp, dxc = schur.solve_damped(ctx, lam, problem, mode, mm_dtype=mm,
                                  reduce=reduce)
    for _ in range(refine):
        dxp, dxc = schur.refine_step(ctx, lam, problem, mode, dxp, dxc,
                                     mm_dtype=mm)
    return dxp, dxc


def _trial(ctx, state, lam: float, problem, mode: str,
           matmul_dtype: Optional[str] = None, refine: int = 0,
           reduce: schur.Reduce = schur.LOCAL):
    """One damping trial: solve, step, trial energy, rho's denominator."""
    mm = _mm(matmul_dtype)
    dxp, dxc = _solve(ctx, lam, problem, mode, mm, refine, reduce)
    x_test = problem_mod.apply_step(state, dxp, dxc)
    (e_test,) = reduce.sum(projection.energy(x_test, problem.obs, problem.tau2,
                                             compute_dtype=mm))
    return x_test, e_test, schur.gradient_dot(ctx, dxp, dxc, lam, reduce)


def _trial_fast(ctx, fast, lam: float, problem, mode: str,
                matmul_dtype: Optional[str] = None, kernels: bool = False,
                refine: int = 0, reduce: schur.Reduce = schur.LOCAL):
    """df32 damping trial: the solve runs at float32 lambda."""
    mm = _mm(matmul_dtype)
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
    print(f"{it:>5}{status:>15}{fval:>15.6g}{rho:>15.6g}{lam:>15.6g}"
          f"{elapsed:>14.4g}s")


class RunLog:
    """What one LM run reports as it goes: the reference's iteration table
    (``verbose``), one JSONL record per trial appended to ``metrics_path``
    (keys iter, status, f, rho, lambda, elapsed_s, and phase when
    ``phase`` is set), and a checkpoint of the accepted state every
    ``checkpoint_every`` iterations. ``to_state`` maps the loop state to the
    BAState a checkpoint holds. ``write=False`` (a sharded run's ranks other
    than 0) prints and writes nothing but still calls ``to_state`` where a
    checkpoint falls due, since on a shard that is a collective. Use it as a
    context manager."""

    def __init__(self, verbose: bool = False,
                 metrics_path: Optional[str] = None,
                 phase: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, to_state=None,
                 write: bool = True):
        self.verbose = verbose and write
        self.metrics_path = metrics_path if write else None
        self.phase = phase
        self.checkpoint_path = checkpoint_path if checkpoint_every else None
        self.checkpoint_every = checkpoint_every
        self.to_state = to_state
        self.write = write
        self._metrics = None

    def __enter__(self):
        if self.verbose:
            _output_header()
            _output_iter_header()
        if self.metrics_path:
            self._metrics = open(self.metrics_path, "a")
        return self

    def __exit__(self, *exc):
        if self.verbose:
            print("-" * 80)
        if self._metrics:
            self._metrics.close()
            self._metrics = None

    def trial(self, it: int, status: str, f: float, rho: float, lam: float,
              elapsed: float) -> None:
        if self.verbose:
            _output_iter(it, status, f, rho, lam, elapsed)
        if self._metrics:
            rec = {"iter": it, "status": status, "f": f, "rho": rho,
                   "lambda": lam, "elapsed_s": elapsed}
            if self.phase:
                rec["phase"] = self.phase
            self._metrics.write(json.dumps(rec) + "\n")
            self._metrics.flush()

    def accepted(self, it: int, x, lam: float, fun_evals: int, hist) -> None:
        if self.checkpoint_path and it % self.checkpoint_every == 0:
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


def minimize(problem: problem_mod.BAProblem, mode: str = "cholesky",
             config: Optional[LMConfig] = None,
             state: Optional[problem_mod.BAState] = None,
             device=None, resume=None,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 0,
             metrics_path: Optional[str] = None,
             metrics_phase: Optional[str] = None,
             reduce: schur.Reduce = schur.LOCAL) -> LMResult:
    """Run LM on a BA problem on ``device`` (CUDA unless the caller passes
    one, e.g. ``device="cpu"``; without CUDA and without ``device`` it
    raises). The problem and state are moved there first. ``mode`` is one
    of ``schur.MODES`` (cholesky, qrchol, qrkit, moreqr, spqr), the
    reference's five binaries as a runtime argument.

    ``resume`` continues from a checkpoint's meta (``state`` is then the
    checkpoint's state); ``checkpoint_path`` with ``checkpoint_every > 0``
    writes the accepted state every that many iterations; ``metrics_path``
    appends one JSONL record per trial, tagged ``metrics_phase``.

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
    hold every rank's points and only rank 0 prints and writes."""
    schur.check_mode(mode)
    config = config or LMConfig()
    if config.polish_iters and (config.geometry or config.matmul_dtype):
        fast_cfg = dataclasses.replace(
            config, polish_iters=0,
            tol_fun=max(config.tol_fun, _POLISH_FAST_TOL))
        observe = dict(checkpoint_path=checkpoint_path,
                       checkpoint_every=checkpoint_every,
                       metrics_path=metrics_path, reduce=reduce)
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
    problem = problem.to(dev)
    state = problem.state if state is None else state.to(dev)
    prepare, trial, to_loop, to_state = step_functions(problem, mode, config,
                                                       dev, reduce)

    def to_checkpoint(x):
        s = to_state(x)
        return dataclasses.replace(s, points=reduce.points(s.points))

    with RunLog(config.verbose, metrics_path, metrics_phase, checkpoint_path,
                checkpoint_every, to_checkpoint,
                write=reduce.rank == 0) as run_log:
        x, status, it, fun_evals, energy, lam = lm_loop(
            to_loop(state), prepare, trial, config, resume=resume,
            run_log=run_log)
    return LMResult(state=to_state(x), status=status, iterations=it,
                    fun_evals=fun_evals, energy=energy, lam=lam)

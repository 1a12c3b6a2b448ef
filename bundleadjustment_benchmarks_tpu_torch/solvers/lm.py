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
are Python floats, i.e. float64.
"""

from __future__ import annotations

import dataclasses
import enum
import math
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


def _mm(matmul_dtype: Optional[str]):
    if matmul_dtype is None:
        return None
    if matmul_dtype != "float32":
        raise ValueError(f"matmul_dtype must be None or 'float32', got "
                         f"{matmul_dtype!r}")
    return torch.float32


# -- per-iteration kernels ---------------------------------------------------------


def _prepare(state, problem, mode: str, matmul_dtype: Optional[str] = None):
    """Residuals, Jacobian, energy and the Schur context (state geometry).
    Returns (ctx, float64 energy, float64 lambda0)."""
    mm = _mm(matmul_dtype)
    blocks = jacobian.residuals_and_jacobian(
        state, problem.obs, problem.tau2, compute_dtype=mm)
    energy = projection.compensated_square_sum(blocks.f)
    ctx = schur.build_context(blocks, problem, mode, mm_dtype=mm)
    return ctx, energy, schur.initial_lambda(ctx, mode).to(torch.float64)


def _prepare_fast(fast, problem, mode: str, matmul_dtype: Optional[str] = None,
                  kernels: bool = False):
    """df32 prepare. ``kernels=True`` runs the residual/Jacobian/energy
    chain as one CUDA kernel launch (same math as the plain path)."""
    mm = _mm(matmul_dtype)
    if kernels:
        blocks, energy = cuda_chain.fused_blocks_energy(
            fast, problem.obs, problem.tau2)
    else:
        blocks, energy = cuda_chain.fused_blocks_energy_plain(
            fast, problem.obs, problem.tau2)
    ctx = schur.build_context(blocks, problem, mode, mm_dtype=mm)
    return ctx, energy, schur.initial_lambda(ctx, mode).to(torch.float64)


def _solve(ctx, lam: float, problem, mode: str, mm, refine: int):
    """The damped step and ``refine`` refinement passes on it."""
    dxp, dxc = schur.solve_damped(ctx, lam, problem, mode, mm_dtype=mm)
    for _ in range(refine):
        dxp, dxc = schur.refine_step(ctx, lam, problem, mode, dxp, dxc,
                                     mm_dtype=mm)
    return dxp, dxc


def _trial(ctx, state, lam: float, problem, mode: str,
           matmul_dtype: Optional[str] = None, refine: int = 0):
    """One damping trial: solve, step, trial energy, rho's denominator."""
    mm = _mm(matmul_dtype)
    dxp, dxc = _solve(ctx, lam, problem, mode, mm, refine)
    x_test = problem_mod.apply_step(state, dxp, dxc)
    e_test = projection.energy(x_test, problem.obs, problem.tau2,
                               compute_dtype=mm)
    return x_test, e_test, schur.gradient_dot(ctx, dxp, dxc, lam)


def _trial_fast(ctx, fast, lam: float, problem, mode: str,
                matmul_dtype: Optional[str] = None, kernels: bool = False,
                refine: int = 0):
    """df32 damping trial: the solve runs at float32 lambda."""
    mm = _mm(matmul_dtype)
    lam32 = float(torch.tensor(lam, dtype=torch.float32))
    dxp, dxc = _solve(ctx, lam32, problem, mode, mm, refine)
    x_test = problem_mod.apply_step_fast(fast, dxp, dxc)
    if kernels:
        e_test = cuda_chain.fused_energy(x_test, problem.obs, problem.tau2)
    else:
        e_test = cuda_chain.fused_energy_plain(x_test, problem.obs,
                                               problem.tau2)
    return x_test, e_test, schur.gradient_dot(ctx, dxp, dxc, lam)


# -- the loop ----------------------------------------------------------------------


def lm_loop(x0, prepare, trial, config: LMConfig):
    """The LM control flow around ``prepare(x) -> (ctx, energy, lam0)`` and
    ``trial(ctx, x, lam) -> (x_test, e_test, rho_scale)``.

    Returns (x, status, iterations, fun_evals, energy, lam) with the
    reference's bookkeeping: a run stopped by max_iter or max_fun_ev counts
    the iteration that found the limit."""
    x = x0
    lam = math.nan  # set from the first prepare's schur.initial_lambda
    lam_inc = float(config.lambda_increase_base)
    it = fun_evals = 0
    hist = [0.0] * config.energy_history_size
    status = LMStatus.Running
    energy = math.inf
    while it + 1 <= config.max_iter and fun_evals <= config.max_fun_ev:
        it += 1
        ctx, energy_t, lam0 = prepare(x)
        fun_evals += 1
        if it == 1:
            lam = float(lam0)
        while True:
            x_t, e_t, rho_scale = trial(ctx, x, lam)
            fun_evals += 1
            # One host read per trial; the outer energy rides along.
            e_t, rho_scale, energy = torch.stack(
                [v.to(torch.float64) for v in (e_t, rho_scale, energy_t)]
            ).tolist()
            if e_t < energy:
                rho = (energy - e_t) / rho_scale
                t = 2.0 * rho - 1.0
                lam = max(lam * max(1.0 / 3.0, 1.0 - t * (t * t)),
                          config.lambda_min)
                lam_inc = float(config.lambda_increase_base)
                energy = e_t
                hist[it % config.energy_history_size] = energy
                break
            if lam > config.lambda_max or not (
                    math.isfinite(lam) and math.isfinite(energy)):
                status = LMStatus.ExceededLambdaMax
                break
            lam *= lam_inc
            lam_inc = lam_inc ** 1.5
        if status != LMStatus.Running:
            break
        if it > config.energy_history_size and \
                abs(energy - max(hist)) < config.tol_fun * energy:
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
             device=None) -> LMResult:
    """Run LM on a BA problem on ``device`` (CUDA unless the caller passes
    one, e.g. ``device="cpu"``; without CUDA and without ``device`` it
    raises). The problem and state are moved there first. ``mode`` is one
    of ``schur.MODES`` (cholesky, qrchol, qrkit, moreqr, spqr), the
    reference's five binaries as a runtime argument."""
    schur.check_mode(mode)
    config = config or LMConfig()
    dev = resolve_device(device)
    kernels = config.use_kernels(dev)
    if config.geometry not in (None, "df32"):
        raise ValueError(f"unknown geometry {config.geometry!r}")
    if config.refine_steps and schur.MODE_STRATEGY[mode][1] != "chol":
        raise ValueError(
            f"refine_steps={config.refine_steps} needs the chol camera "
            f"solver (cholesky, qrchol, moreqr); mode {mode!r} keeps its rhs "
            "in its lambda-free cache")
    problem = problem.to(dev)
    state = problem.state if state is None else state.to(dev)

    if config.geometry == "df32":
        def prepare(x):
            return _prepare_fast(x, problem, mode, config.matmul_dtype,
                                 kernels=kernels)

        def trial(ctx, x, lam):
            return _trial_fast(ctx, x, lam, problem, mode,
                               config.matmul_dtype, kernels=kernels,
                               refine=config.refine_steps)

        x0 = problem_mod.to_fast(state)
    else:
        def prepare(x):
            return _prepare(x, problem, mode, config.matmul_dtype)

        def trial(ctx, x, lam):
            return _trial(ctx, x, lam, problem, mode, config.matmul_dtype,
                          refine=config.refine_steps)

        x0 = state
    x, status, it, fun_evals, energy, lam = lm_loop(x0, prepare, trial, config)
    if config.geometry == "df32":
        x = problem_mod.from_fast(x, dtype=state.T.dtype)
    return LMResult(state=x, status=status, iterations=it,
                    fun_evals=fun_evals, energy=energy, lam=lam)

"""Ellipse fitting with the PyTorch port's LM driver: the reference's
missing dense LM example.

The reference build declares an Ellipse_Fitting_Test target whose source is
absent (src/CMakeLists.txt:180-186); the LM headers cite
examples/ellipse_fitting.cpp (BacktrackLevMarqCholesky.h:8,94) as the small
dense usage example of the backtracking LM driver. This is the counterpart
of ``examples/ellipse_fitting.py`` for ``bundleadjustment_benchmarks_tpu_torch``:
the same residual, samples and (prepare, trial) pair, run by the same
``lm.lm_loop`` the bundle adjuster runs, which shows that the driver is
problem-agnostic.

Parameters x = (cx, cy, a, b, phi); the residual of a sample is the
distance of the rotated, translated and axis-scaled sample from the unit
circle. The Jacobian comes from ``torch.func.jacfwd``.

Run:  python examples/ellipse_fitting_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bundleadjustment_benchmarks_tpu_torch import resolve_device  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch.solvers import lm  # noqa: E402


def ellipse_residuals(params: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Algebraic residuals: |R(-phi) (p - c)| scaled by the axes, minus 1."""
    cx, cy, a, b, phi = params.unbind()
    d = samples - torch.stack([cx, cy])
    c, s = torch.cos(phi), torch.sin(phi)
    u = (c * d[:, 0] + s * d[:, 1]) / a
    v = (-s * d[:, 0] + c * d[:, 1]) / b
    return torch.sqrt(u * u + v * v + 1e-12) - 1.0


def make_kernels(samples: torch.Tensor):
    """``lm.lm_loop``'s (prepare, trial) for the dense ellipse problem."""
    jac = torch.func.jacfwd(ellipse_residuals)

    def prepare(x):
        r = ellipse_residuals(x, samples)
        J = jac(x, samples)
        jtj = J.T @ J
        lam0 = 1e-12 * jtj.diagonal().max()  # the cholesky driver's rule
        return (jtj, -J.T @ r), (r * r).sum(), lam0

    def trial(ctx, x, lam):
        jtj, jtres = ctx
        A = jtj + lam * torch.eye(jtj.shape[0], dtype=jtj.dtype, device=jtj.device)
        Q, R = torch.linalg.qr(A)
        dx = torch.linalg.solve_triangular(R, (Q.T @ jtres)[:, None], upper=True)[:, 0]
        x_test = x + dx
        r = ellipse_residuals(x_test, samples)
        return x_test, (r * r).sum(), dx @ (lam * dx + jtres)

    return prepare, trial


def fit_ellipse(samples, x0=None, config=None, device=None) -> lm.LMResult:
    """Fit an ellipse to (n, 2) samples with the shared LM loop, in float64
    on ``device`` (CUDA unless the caller names one, e.g. ``"cpu"``).
    ``x0`` defaults to the samples' mean and sqrt(2) x their standard
    deviation, phi 0; ``config`` to ``LMConfig(drive="host", max_iter=100)``
    (the fit runs the host loop, ``lm.lm_loop``), whose ``verbose`` prints
    the reference's iteration table."""
    dev = resolve_device(device)
    samples = torch.as_tensor(np.asarray(samples), dtype=torch.float64, device=dev)
    if x0 is None:
        c = samples.mean(dim=0)
        r = samples.std(dim=0, correction=0) * np.sqrt(2.0)
        x0 = torch.cat([c, r, samples.new_zeros(1)])
    else:
        x0 = torch.as_tensor(np.asarray(x0), dtype=torch.float64, device=dev)
    config = config or lm.LMConfig(drive="host", max_iter=100)
    prepare, trial = make_kernels(samples)
    with lm.RunLog(config.verbose) as run_log:
        x, status, it, fun_evals, energy, lam = lm.lm_loop(
            x0, prepare, trial, config, run_log=run_log)
    return lm.LMResult(state=x, status=status, iterations=it,
                       fun_evals=fun_evals, energy=energy, lam=lam)


def sample_ellipse(n=200, center=(1.0, -2.0), axes=(3.0, 1.5), phi=0.6,
                   noise=0.02, seed=0) -> np.ndarray:
    """n noisy samples of an ellipse, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    c, s = np.cos(phi), np.sin(phi)
    x = axes[0] * np.cos(t)
    y = axes[1] * np.sin(t)
    pts = np.stack([center[0] + c * x - s * y, center[1] + s * x + c * y], axis=1)
    return pts + rng.normal(scale=noise, size=pts.shape)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Fit an ellipse with the port's LM.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    result = fit_ellipse(sample_ellipse(), device=args.device)
    cx, cy, a, b, phi = result.state.tolist()
    print(f"status: {lm.STATUS_STRINGS[result.status]}")
    print(f"iterations: {result.iterations}  funEvals: {result.fun_evals}")
    print(f"center=({cx:.4f}, {cy:.4f}) axes=({a:.4f}, {b:.4f}) phi={phi:.4f}")
    print(f"final energy: {result.energy:.6g}")


if __name__ == "__main__":
    main()

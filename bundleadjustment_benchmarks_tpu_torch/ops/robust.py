"""Robust kernel of the BA objective (reference BAFunctor.h:147-178, 227-242)."""

from __future__ import annotations

import torch

#: Epsilon guard of the reference residual/Jacobian scaling (BAFunctor.h:159).
EPS_PSI_RESIDUAL = 1e-15


def psi(tau2, r2):
    """Smooth truncated quadratic: r2 (2 - r2/tau2)/4 if r2 < tau2 else tau2/4."""
    return torch.where(
        r2 < tau2, r2 * (2.0 - r2 / tau2) / 4.0, torch.full_like(r2, tau2 / 4.0)
    )


def robust_scale(tau2, r: torch.Tensor) -> torch.Tensor:
    """Per-observation scale sqrt(psi(|r|^2)) / max(eps, |r|); (..., 2) -> (...,)."""
    r2 = (r * r).sum(-1)
    return torch.sqrt(psi(tau2, r2)) / torch.clamp(
        torch.sqrt(r2), min=EPS_PSI_RESIDUAL
    )


def outer_coeffs(rn2: torch.Tensor, tau2: torch.Tensor):
    """Stable closed form of the robust 2x2 outer factor.

    The reference's factor (BAFunctor.h:227-242) is out = cr r r^T + cd I with
    cr = (W/2 psi^-1/2 - sqrt(psi)/r^2)/|r|, a difference of nearly equal
    terms for small residuals. With u = rn2/tau2 it is exactly
      inlier  (rn2 <  tau2): cr = -1/(2 tau2 sqrt(2-u)), cd = sqrt(2-u)/2
      outlier (rn2 >= tau2): cr = -tau/(2 rn2^{3/2}),    cd = tau/(2 |r|)
    and cd is also the residual scale sqrt(psi)/|r|. ``tau2`` is a 0-dim
    tensor on rn2's device and dtype, so every division here is a true
    division (a CUDA tensor divided by a Python scalar is multiplied by the
    scalar's reciprocal instead). The CUDA chain kernels repeat these ops in
    this order. Returns (cr, cd).
    """
    u = rn2 / tau2
    inl = rn2 < tau2
    tau = torch.sqrt(tau2)
    som = torch.sqrt(torch.clamp(2.0 - u, min=0.0))  # inlier branch only
    rn2_out = torch.maximum(rn2, tau2)  # exact on the outlier branch
    rnorm_out = torch.sqrt(rn2_out)
    cr = torch.where(
        inl,
        -torch.reciprocal(2.0 * tau2 * torch.clamp(som, min=1.0)),
        torch.div(-tau, 2.0 * rn2_out * rnorm_out),
    )
    cd = torch.where(inl, som / 2.0, torch.div(tau, 2.0 * rnorm_out))
    return cr, cd

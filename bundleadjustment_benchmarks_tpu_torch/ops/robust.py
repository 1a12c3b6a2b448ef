"""Robust kernel of the BA objective (reference BAFunctor.h:147-178, 227-242)."""

from __future__ import annotations

import torch

#: Epsilon guard of the reference residual/Jacobian scaling (BAFunctor.h:159).
EPS_PSI_RESIDUAL = 1e-15


def psi(tau2, r2):
    """Smooth truncated quadratic: r2 (2 - r2/tau2)/4 if r2 < tau2 else tau2/4.
    ``tau2`` is a Python float or a 0-dim tensor of r2's dtype."""
    return torch.where(r2 < tau2, r2 * (2.0 - r2 / tau2) / 4.0, tau2 / 4.0)


def psi_cubic(tau2, r2):
    """The "true objective" kernel r2 (3 - 3 r2/tau2 + (r2/tau2)^2)/6, capped
    at tau2/6 (reference Utils.h:10-13). Its one caller passes a norm as
    ``r2``, as the reference does (utils/stats.py)."""
    r4 = r2 * r2
    tau4 = tau2 * tau2
    return torch.where(r2 < tau2, r2 * (3.0 - 3.0 * r2 / tau2 + r4 / tau4) / 6.0,
                       tau2 / 6.0)


def psi_weight(tau2, r2):
    """max(0, 1 - r2/tau2) (BAFunctor.h:148)."""
    return torch.maximum(torch.zeros_like(r2), 1.0 - r2 / tau2)


def robust_scale(tau2, r: torch.Tensor) -> torch.Tensor:
    """Per-observation scale sqrt(psi(|r|^2)) / max(eps, |r|); (..., 2) -> (...,)."""
    r2 = (r * r).sum(-1)
    return torch.sqrt(psi(tau2, r2)) / torch.clamp(
        torch.sqrt(r2), min=EPS_PSI_RESIDUAL
    )


def robust_outer_derivative(tau2, r: torch.Tensor) -> torch.Tensor:
    """2x2 outer derivative of the robustified residual with respect to the
    raw residual, as the reference writes it (BAFunctor.h:227-242):
        W/2 psi^-1/2 r r^T/|r| + sqrt(psi)/r^2 (|r| I - r r^T/|r|)
    with eps guards on 1/sqrt(psi), 1/r^2 and 1/|r|; the JAX package's
    expressions in its order. It cancels for small residuals (see
    outer_coeffs) and is 0 at r = 0. The f64 Jacobian uses it; ``tau2``
    becomes a 0-dim tensor, so its divisions are true divisions on CUDA too.
    ``r`` is (..., 2); returns (..., 2, 2)."""
    eps = torch.as_tensor(EPS_PSI_RESIDUAL, dtype=r.dtype, device=r.device)
    tau2 = torch.as_tensor(tau2, dtype=r.dtype, device=r.device)
    r2 = (r * r).sum(-1)
    W = psi_weight(tau2, r2)
    sqrt_psi = torch.sqrt(psi(tau2, r2))
    rsqrt_psi = 1.0 / torch.maximum(eps, sqrt_psi)
    rcp_r2 = 1.0 / torch.maximum(eps, r2)
    rnorm_r = 1.0 / torch.maximum(eps, torch.sqrt(r2))
    rrt = r[..., :, None] * r[..., None, :] * rnorm_r[..., None, None]
    rI = torch.sqrt(r2)[..., None, None] * torch.eye(2, dtype=r.dtype,
                                                     device=r.device)
    return ((W / 2.0 * rsqrt_psi)[..., None, None] * rrt
            + (sqrt_psi * rcp_r2)[..., None, None] * (rI - rrt))


def outer_coeffs(rn2: torch.Tensor, tau2: torch.Tensor):
    """Stable closed form of the robust 2x2 outer factor (the df32 chain).

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

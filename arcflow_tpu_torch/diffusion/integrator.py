"""Closed-form trajectory integration for mixture-of-momentum policies.

Counterpart of ``arcflow_tpu/diffusion/integrator.py`` (``_safe_expm1_over_x``
and ``momentum_integration``). Each component ``u_k(sigma) = m_k *
exp(rate_k * (sigma_src - sigma))`` integrates in closed form over a sigma
interval. The math runs in fp32 with autocast off: 2-NFE quality depends on
it being exact. ``policy_average_u`` is the student's mean velocity over a
span, which the distillation loss regresses.

Conventions: ``sigma_*`` are (B,) noise levels; x moves from high sigma to
low, so ``dt_step = sigma_start - sigma_end >= 0`` and the displacement is
subtracted from x.
"""

from __future__ import annotations

import torch

from .policies.arcflow import ArcFlowPolicy, _bshape


def _safe_expm1_over_x(x: torch.Tensor, eps: float) -> torch.Tensor:
    """expm1(x)/x with a sign-safe clamp |x| >= eps (the limit at 0 is 1)."""
    sign = torch.where(x >= 0, 1.0, -1.0)
    x_safe = sign * torch.clamp(x.abs(), min=eps)
    return torch.expm1(x_safe) / x_safe


def momentum_integration(policy: ArcFlowPolicy, x_t_start: torch.Tensor,
                         sigma_t_start, sigma_t_end, eps: float = 1e-4,
                         return_mid: bool = False):
    """Advance x analytically from ``sigma_t_start`` to ``sigma_t_end``.

    Per component the displacement is
    ``m_k * exp(rate_k * dt_past) * dt_step * expm1(rate_k*dt_step)/(rate_k*dt_step)``,
    mixed by the softmax weights; component 0 (rate 0) moves ``m_0 * dt_step``.
    With ``return_mid`` also returns ``x_start - displacement / 2`` (the
    half-displacement midpoint the JAX package keeps bit-compatible with
    its reference).

    Returns x_t_end in ``x_t_start``'s dtype (fp32 math), or
    (x_t_end, x_t_mid) with ``return_mid``.
    """
    dev = x_t_start.device
    with torch.autocast(device_type=dev.type, enabled=False):
        ndim = x_t_start.dim()
        b = x_t_start.shape[0]
        f32 = torch.float32
        sigma_t_start = torch.as_tensor(sigma_t_start, dtype=f32,
                                        device=dev).reshape(b)
        sigma_t_end = torch.as_tensor(sigma_t_end, dtype=f32,
                                      device=dev).reshape(b)

        dt_past = policy.sigma_t_src - sigma_t_start               # (B,)
        dt_step = sigma_t_start - sigma_t_end                      # (B,)

        v_at_start = policy.means_u * policy.decay(dt_past)        # (B, K, ...)
        dt_step_k = _bshape(dt_step, ndim)[:, None]                # (B, 1, ...)
        step_factor = _safe_expm1_over_x(policy.loggammas * dt_step_k, eps)
        step_factor = torch.cat(
            [torch.ones_like(step_factor[:, :1]), step_factor], dim=1)

        displacement_k = v_at_start * dt_step_k * step_factor
        displacement = (policy.weights() * displacement_k).sum(dim=1)
        x32 = x_t_start.to(f32)
        x_t_end = (x32 - displacement).to(x_t_start.dtype)
        if return_mid:
            x_t_mid = (x32 - 0.5 * displacement).to(x_t_start.dtype)
            return x_t_end, x_t_mid
        return x_t_end


def policy_average_u(policy: ArcFlowPolicy, x_t_start: torch.Tensor,
                     sigma_t_start, sigma_t_end, raw_t_start, raw_t_end,
                     total_substeps: int, eps: float = 1e-4) -> torch.Tensor:
    """The policy's mean velocity over [sigma_t_start, sigma_t_end]: the
    closed-form displacement over the span's sigma length; spans shorter
    than 2 of ``total_substeps`` (in raw time) take the local velocity at
    the start instead, per sample (JAX ``integrator.py:91-116``)."""
    dev = x_t_start.device
    b, ndim = x_t_start.shape[0], x_t_start.dim()
    sigma_t_start, sigma_t_end, raw_t_start, raw_t_end = (
        torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(b)
        for v in (sigma_t_start, sigma_t_end, raw_t_start, raw_t_end))
    is_small = torch.round((raw_t_start - raw_t_end) * total_substeps) < 2
    x_t_end = momentum_integration(policy, x_t_start, sigma_t_start,
                                   sigma_t_end, eps)
    denom = torch.clamp(sigma_t_start - sigma_t_end, min=eps)
    mean_u = (x_t_start - x_t_end) / _bshape(denom, ndim)
    local_u = policy.velocity(sigma_t_start)
    return torch.where(_bshape(is_small, ndim), local_u, mean_u)

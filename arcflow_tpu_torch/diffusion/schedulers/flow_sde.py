"""Flow-matching SDE scheduler with churn parameter h.

Counterpart of ``arcflow_tpu/diffusion/schedulers/flow_sde.py``: ``h``
interpolates between the deterministic ODE (h=0 -> m=1, noise off) and
fully ancestral sampling (h='inf' -> m=0, epsilon fully resampled):

    m = (sigma_next * alpha / (sigma * alpha_next))^{h^2}
    x_next = alpha_next * x0 + sigma_next * (m * eps_hat + sqrt(1 - m^2) * noise)

The noise is one ``torch.randn`` draw from the step's generator (a
different stream from the JAX key's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .flow_euler_ode import FlowEulerODEScheduler, as_f32


@dataclasses.dataclass(frozen=True)
class FlowSDEScheduler(FlowEulerODEScheduler):
    """Stochastic flow sampler; shares the sigma grid with the ODE one."""

    h: Union[float, str] = 1.0

    def step(self, model_output: torch.Tensor, sample: torch.Tensor, sigma,
             sigma_next, prediction_type: str = 'u', eps: float = 1e-6,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if prediction_type not in ('u', 'x0'):
            raise ValueError(f'invalid prediction_type {prediction_type}')
        ori_dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()
        sigma, sigma_next = (as_f32(s, sample) for s in (sigma, sigma_next))
        alpha = 1 - sigma
        alpha_next = 1 - sigma_next

        if prediction_type == 'u':
            x0 = sample - sigma * model_output
            epsilon = sample + alpha * model_output
        else:
            x0 = model_output
            epsilon = (sample - alpha * x0) / sigma.clamp_min(eps)

        noise = torch.randn(sample.shape, generator=generator,
                            device=sample.device, dtype=torch.float32)
        if self.h == 'inf':
            m = torch.zeros_like(sigma)
        elif self.h == 0.0:
            m = torch.ones_like(sigma)
        else:
            if not (isinstance(self.h, (int, float)) and self.h > 0.0):
                raise ValueError(f'h must be > 0 or "inf", got {self.h!r}')
            m = (sigma_next * alpha / (sigma * alpha_next).clamp_min(eps)
                 ) ** (float(self.h) ** 2)
        churn = torch.sqrt((1 - m.square()).clamp_min(0.0))
        prev = alpha_next * x0 + sigma_next * (m * epsilon + churn * noise)
        return prev.to(ori_dtype)

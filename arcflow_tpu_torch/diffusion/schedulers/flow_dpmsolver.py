"""High-order multistep flow solvers: DPM-Solver++(2M), UniPC, DEIS,
SA-Solver, and the ``FlowAdapterScheduler`` dispatcher.

Counterpart of ``arcflow_tpu/diffusion/schedulers/flow_dpmsolver.py``. The
solvers run natively on flow sigmas (alpha = 1 - sigma, lambda =
log(alpha / sigma)) and are stateful: ``init_state(x)`` gives the multistep
history (the previous x0 or epsilon prediction, its lambda and a validity
flag) and ``step_with_state`` returns (x_next, new state). The JAX sampler
threads that state through its ``lax.scan``; the port's ``forward_test``
carries it through its step loop. Arithmetic runs in fp32, as in JAX.
SA-Solver with ``tau`` > 0 draws its churn from the step's
``torch.Generator``, where JAX draws from the step's PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...registry import SCHEDULERS
from .flow_euler_ode import FlowEulerODEScheduler, as_f32
from .flow_sde import FlowSDEScheduler


def _nonzero(h: torch.Tensor) -> torch.Tensor:
    """``h`` with 0 replaced by 1 (a safe divisor)."""
    return torch.where(h == 0, torch.ones_like(h), h)


@SCHEDULERS.register_module()
@dataclasses.dataclass(frozen=True)
class FlowDPMSolverScheduler(FlowEulerODEScheduler):
    """Multistep DPM-Solver++ on the flow parameterization: order 1 is the
    exact x0-form exponential integrator (DDIM-like), order 2 the 2M
    linear-multistep variant."""

    solver_order: int = 2

    stateful = True

    def init_state(self, x: torch.Tensor) -> dict:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return dict(prev_x0=torch.zeros_like(x, dtype=torch.float32),
                    prev_lambda=zero, valid=zero)

    @staticmethod
    def _lambda(sigma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        sigma = sigma.clamp(eps, 1 - eps)
        return torch.log((1 - sigma) / sigma)

    def _prologue(self, model_output, sample, sigma, sigma_next, eps):
        """(sample, model output) in fp32, the sigmas as fp32 tensors,
        lambda and the step h = lambda_next - lambda."""
        sample = sample.float()
        out = model_output.float()
        sigma, sigma_next = (as_f32(s, sample) for s in (sigma, sigma_next))
        lam = self._lambda(sigma, eps)
        return (sample, out, sigma, sigma_next, lam,
                self._lambda(sigma_next, eps) - lam)

    def _multistep(self, pred, state, lam, h, sigma_next, eps):
        """``pred`` plus the second-order correction from the history, off
        on the first and on the terminal step (lower_order_final)."""
        if self.solver_order < 2:
            return pred
        r = (lam - state['prev_lambda']) / _nonzero(h)
        corr = (pred - state['prev_x0']) / torch.clamp_min(2 * r, eps)
        use_corr = state['valid'] * (sigma_next >= eps).float()
        return pred + use_corr * corr

    @staticmethod
    def _new_state(pred, lam) -> dict:
        return dict(prev_x0=pred, prev_lambda=lam,
                    valid=torch.ones_like(lam))

    def step_with_state(self, model_output: torch.Tensor,
                        sample: torch.Tensor, sigma, sigma_next,
                        state: dict, prediction_type: str = 'u',
                        eps: float = 1e-6,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, dict]:
        sample, out, sigma, sigma_next, lam, h = self._prologue(
            model_output, sample, sigma, sigma_next, eps)
        x0 = sample - sigma * out if prediction_type == 'u' else out
        d = self._multistep(x0, state, lam, h, sigma_next, eps)
        alpha_next = 1 - sigma_next
        ratio = sigma_next / sigma.clamp_min(eps)
        x_next = ratio * sample - alpha_next * torch.expm1(-h) * d
        # terminal step: land exactly on the x0 estimate
        x_next = torch.where(sigma_next < eps, d, x_next)
        return x_next, self._new_state(x0, lam)

    def step(self, model_output, sample, sigma, sigma_next,
             prediction_type='u', eps=1e-6, generator=None):
        """Stateless fallback: the order-1 exponential integrator."""
        x, _ = self.step_with_state(model_output, sample, sigma, sigma_next,
                                    self.init_state(sample),
                                    prediction_type=prediction_type, eps=eps,
                                    generator=generator)
        return x


@SCHEDULERS.register_module()
@dataclasses.dataclass(frozen=True)
class FlowUniPCScheduler(FlowDPMSolverScheduler):
    """UniPC-style predictor-corrector on flow sigmas: the DPM-Solver++(2M)
    history with the UniC-1 corrector in its B(h) = h variant."""

    def step_with_state(self, model_output, sample, sigma, sigma_next, state,
                        prediction_type='u', eps=1e-6, generator=None):
        ori_dtype = sample.dtype
        sample32, out, sigma, sigma_next, lam, h = self._prologue(
            model_output, sample, sigma, sigma_next, eps)
        x0 = sample32 - sigma * out if prediction_type == 'u' else out
        r = (lam - state['prev_lambda']) / _nonzero(h)
        hh = -h   # data-prediction convention
        phi1 = torch.expm1(hh)
        # lower_order_final: no multistep term on the terminal step
        use_corr = state['valid'] * (sigma_next >= eps).float()
        d1 = (x0 - state['prev_x0']) / r.clamp_min(eps) * use_corr
        alpha_next = 1 - sigma_next
        ratio = sigma_next / sigma.clamp_min(eps)
        x_next = ratio * sample32 - alpha_next * phi1 * x0 \
            - alpha_next * (phi1 / _nonzero(hh) - 1.0) * d1
        x_next = torch.where(sigma_next < eps, x0, x_next)
        return x_next.to(ori_dtype), self._new_state(x0, lam)


@SCHEDULERS.register_module()
@dataclasses.dataclass(frozen=True)
class FlowDEISScheduler(FlowDPMSolverScheduler):
    """DEIS multistep on flow sigmas: the exponential integrator in the
    noise-prediction parameterization with AB2 extrapolation in lambda.
    Order-1 exact update: x_next = (alpha_next / alpha) x - sigma_next
    expm1(h) eps_hat. The history carries the epsilon prediction."""

    def step_with_state(self, model_output, sample, sigma, sigma_next, state,
                        prediction_type='u', eps=1e-6, generator=None):
        ori_dtype = sample.dtype
        sample32, out, sigma, sigma_next, lam, h = self._prologue(
            model_output, sample, sigma, sigma_next, eps)
        alpha = 1 - sigma
        if prediction_type == 'u':
            # x_t = alpha x0 + sigma eps, u = eps - x0
            epsilon = sample32 + alpha * out
            x0 = sample32 - sigma * out
        else:
            x0 = out
            epsilon = (sample32 - alpha * x0) / sigma.clamp_min(eps)
        d = self._multistep(epsilon, state, lam, h, sigma_next, eps)
        alpha_next = 1 - sigma_next
        ratio = alpha_next / alpha.clamp_min(eps)
        x_next = ratio * sample32 - sigma_next * torch.expm1(h) * d
        # terminal step: expm1(h) blows up as sigma_next -> 0; land on the
        # exact limit alpha_next * x0
        x_next = torch.where(sigma_next < eps, alpha_next * x0, x_next)
        # first step from pure noise (alpha -> 0): alpha_next / alpha is
        # singular there, so take the exact x0-form order-1 update
        x0_form = (sigma_next / sigma.clamp_min(eps)) * sample32 \
            - alpha_next * torch.expm1(-h) * x0
        x_next = torch.where(alpha < 1e-4, x0_form, x_next)
        return x_next.to(ori_dtype), self._new_state(epsilon, lam)


@SCHEDULERS.register_module()
@dataclasses.dataclass(frozen=True)
class FlowSASolverScheduler(FlowDPMSolverScheduler):
    """SA-Solver (stochastic Adams) on flow sigmas: data-prediction
    multistep with an exact noise channel of scale ``tau``. The order-1
    transition (marginal-preserving for any tau >= 0):

      x_next = (sigma_next / sigma) e^{-tau^2 h} x
               + alpha_next (1 - e^{-(1 + tau^2) h}) x0_hat
               + sigma_next sqrt(1 - e^{-2 tau^2 h}) z

    tau = 0 is DPM-Solver++ exactly; order 2 adds the 2M solver's multistep
    x0 gradient. z comes from ``generator``, which tau > 0 needs."""

    tau: float = 1.0

    def step_with_state(self, model_output, sample, sigma, sigma_next, state,
                        prediction_type='u', eps=1e-6, generator=None):
        ori_dtype = sample.dtype
        sample32, out, sigma, sigma_next, lam, h = self._prologue(
            model_output, sample, sigma, sigma_next, eps)
        x0 = sample32 - sigma * out if prediction_type == 'u' else out
        d = self._multistep(x0, state, lam, h, sigma_next, eps)
        tau2 = float(self.tau) ** 2
        alpha_next = 1 - sigma_next
        ratio = sigma_next / sigma.clamp_min(eps)
        drift = ratio * torch.exp(-tau2 * h) * sample32 \
            - alpha_next * torch.expm1(-(1 + tau2) * h) * d
        if tau2 > 0:
            if generator is None:
                raise ValueError('SA-Solver with tau > 0 needs a generator')
            z = torch.randn(sample32.shape, generator=generator,
                            device=sample32.device, dtype=torch.float32)
            churn = torch.sqrt(torch.clamp_min(-torch.expm1(-2 * tau2 * h),
                                               0.0))
            drift = drift + sigma_next * churn * z
        x_next = torch.where(sigma_next < eps, d, drift)
        return x_next.to(ori_dtype), self._new_state(x0, lam)


# the reference's diffusers scheduler names -> the native solver
ADAPTER_SCHEDULERS = {
    'UniPCMultistep': FlowUniPCScheduler,
    'DPMSolverMultistep': FlowDPMSolverScheduler,
    'DPMSolverSinglestep': FlowDPMSolverScheduler,
    'DEISMultistep': FlowDEISScheduler,
    'SASolver': FlowSASolverScheduler,
    'EulerDiscrete': FlowEulerODEScheduler,
    'EulerAncestralDiscrete': FlowSDEScheduler,
}


@SCHEDULERS.register_module(name='FlowAdapterScheduler')
def FlowAdapterScheduler(base_scheduler: str = 'UniPCMultistep', **kwargs):
    """The reference configs' dispatcher: ``base_scheduler`` (a diffusers
    scheduler name, UniPCMultistep by default) picks the native flow-sigma
    solver, which takes the kwargs it has fields for."""
    if base_scheduler not in ADAPTER_SCHEDULERS:
        raise AttributeError(f'Unsupported base_scheduler [{base_scheduler}];'
                             f' options: {sorted(ADAPTER_SCHEDULERS)}')
    cls = ADAPTER_SCHEDULERS[base_scheduler]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in fields})

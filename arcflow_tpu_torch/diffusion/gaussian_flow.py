"""Rectified-flow base module: the forward process, the denoiser call, the
CFG'd velocity and the test scheduler.

Counterpart of ``arcflow_tpu/diffusion/gaussian_flow.py`` (``apply_guidance``,
``_bview``, ``GaussianFlow.sample_forward_diffusion``,
``forward_transition``, ``sample_forward_transition``, ``pred``,
``_maybe_dropout_rng``, ``forward_u`` and ``build_test_scheduler``). The
JAX module passes params and PRNG keys into every method; here the denoiser
is an ``nn.Module`` holding its parameters, and randomness comes from an
explicit ``torch.Generator``. The scheduler-driven sampler and the
data-based training loss of plain flow matching, and the orthogonal and
interval forms of CFG (no config sets them), wait for their slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .sampler import ContinuousTimeStepSampler
from .schedulers import SCHEDULERS


def apply_guidance(pos: torch.Tensor, neg: torch.Tensor,
                   guidance_scale: float) -> torch.Tensor:
    """Classifier-free guidance bias (pos - neg) * (scale - 1)."""
    return (pos - neg) * (guidance_scale - 1.0)


def _bview(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with ``ndim`` dims."""
    return a.reshape(a.shape[0], *((ndim - a.dim()) * [1])) \
        if a.dim() < ndim else a


class GaussianFlow:
    """Flow-matching wrapper around a denoiser ``nn.Module`` whose forward is
    ``denoising(x_t, t, **cond)``; the teacher of the distillation."""

    is_multistep = False

    def __init__(self, denoising: nn.Module, flow_loss=None,
                 num_timesteps: int = 1000,
                 timestep_sampler: Optional[ContinuousTimeStepSampler] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        self.denoising = denoising
        self.flow_loss = flow_loss
        self.num_timesteps = num_timesteps
        self.timestep_sampler = timestep_sampler or ContinuousTimeStepSampler(
            num_timesteps=num_timesteps)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

    # ---- forward process -------------------------------------------------
    def sample_forward_diffusion(self, x_0: torch.Tensor, t: torch.Tensor,
                                 noise: torch.Tensor):
        """x_t = (1 - sigma) x_0 + sigma noise with sigma = t /
        num_timesteps; returns (x_t, 1 - sigma, sigma)."""
        std = _bview(torch.as_tensor(t, dtype=torch.float32)
                     / self.num_timesteps, x_0.dim())
        mean = 1.0 - std
        return x_0 * mean + noise * std, mean, std

    def forward_transition(self, x_t_src: torch.Tensor, sigma_src,
                           sigma_tgt, eps: float = 1e-6):
        """Marginal-preserving transition kernel src -> tgt: ({mean, var},
        scale)."""
        ndim = x_t_src.dim()
        sigma_src = _bview(torch.as_tensor(sigma_src, dtype=torch.float32),
                           ndim)
        sigma_tgt = _bview(torch.as_tensor(sigma_tgt, dtype=torch.float32),
                           ndim)
        scale = (1 - sigma_tgt) / (1 - sigma_src).clamp_min(eps)
        var = sigma_tgt.square() - (scale * sigma_src).square()
        return dict(mean=x_t_src * scale, var=var), scale

    def sample_forward_transition(self, generator: torch.Generator,
                                  x_t_src: torch.Tensor, sigma_src,
                                  sigma_tgt) -> torch.Tensor:
        trans, _ = self.forward_transition(x_t_src, sigma_src, sigma_tgt)
        noise = torch.randn(x_t_src.shape, generator=generator,
                            device=x_t_src.device, dtype=torch.float32)
        return trans['mean'] + noise * torch.sqrt(trans['var'].clamp_min(0.0))

    def pred(self, x_t: torch.Tensor, t, dropout_seed: Optional[int] = None,
             **kwargs):
        """One denoiser forward; ``t`` is model time in [0, num_timesteps],
        a scalar or (B,). ``dropout_seed`` (training only) turns on the
        denoiser's LoRA dropout; without it every forward is deterministic."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x_t.device)
        if t.dim() == 0:
            t = t.expand(x_t.shape[0])
        if dropout_seed is not None:
            kwargs['dropout_seed'] = dropout_seed
        return self.denoising(x_t, t, **kwargs)

    def _maybe_dropout_seed(self, generator: torch.Generator
                            ) -> Optional[int]:
        """A dropout seed drawn from ``generator``, only when the denoiser
        has ``lora_dropout`` (so dropout-free models draw nothing)."""
        if getattr(self.denoising, 'lora_dropout', 0.0) > 0.0:
            return int(torch.randint(2 ** 62, (1,), generator=generator,
                                     device=generator.device).item())
        return None

    def forward_u(self, x_t: torch.Tensor, t: torch.Tensor,
                  guidance_scale: float = 1.0, **kwargs):
        """u at (x_t, t), with CFG when ``guidance_scale`` > 1: then every
        conditioning tensor in ``kwargs`` is ``cat([negative, positive])``
        along the batch."""
        if guidance_scale <= 1.0:
            return self.pred(x_t, t, **kwargs)
        out = self.pred(torch.cat([x_t, x_t], dim=0), torch.cat([t, t], dim=0),
                        **kwargs)
        neg, pos = out.chunk(2, dim=0)
        return pos + apply_guidance(pos, neg, guidance_scale)

    # ---- sampling ------------------------------------------------------------
    def build_test_scheduler(self, cfg: dict):
        """The scheduler ``cfg['sampler']`` names (default 'FlowEulerODE'),
        with ``sampler_kwargs`` and the shift settings of ``cfg`` or, where
        it has none, of the timestep sampler."""
        name = cfg.get('sampler', 'FlowEulerODE')
        sched_cls = SCHEDULERS.get(name + 'Scheduler')
        if sched_cls is None:
            raise AttributeError(f'Cannot find sampler [{name}]. '
                                 f'Available: {sorted(SCHEDULERS)}')
        kwargs = dict(cfg.get('sampler_kwargs', {}))
        for key in ('shift', 'use_dynamic_shifting', 'base_seq_len',
                    'max_seq_len', 'base_logshift', 'max_logshift'):
            if key not in kwargs:
                kwargs[key] = cfg.get(key, getattr(self.timestep_sampler, key))
        return sched_cls(num_train_timesteps=self.num_timesteps, **kwargs)

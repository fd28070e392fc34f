"""Rectified-flow base module: the denoiser call and the CFG'd velocity.

Counterpart of ``arcflow_tpu/diffusion/gaussian_flow.py`` (``apply_guidance``,
``GaussianFlow.pred``, ``forward_u`` and ``_maybe_dropout_rng``). The JAX
module passes params and PRNG keys into every method; here the denoiser is
an ``nn.Module`` holding its parameters, and randomness comes from an
explicit ``torch.Generator``. The scheduler-driven sampler, the
data-based training loss and the orthogonal and interval forms of CFG (no
config sets them) wait for their slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .sampler import ContinuousTimeStepSampler


def apply_guidance(pos: torch.Tensor, neg: torch.Tensor,
                   guidance_scale: float) -> torch.Tensor:
    """Classifier-free guidance bias (pos - neg) * (scale - 1)."""
    return (pos - neg) * (guidance_scale - 1.0)


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
        self.timestep_sampler = timestep_sampler or ContinuousTimeStepSampler()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

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

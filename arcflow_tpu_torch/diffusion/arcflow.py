"""ArcFlow few-step sampling (the inference half of the distillation module).

Counterpart of ``arcflow_tpu/diffusion/arcflow.py``: ``_seq_len_of``,
``make_policy``, ``pred`` (from ``gaussian_flow.py:GaussianFlow.pred``) and
``ArcFlowImitationDataFree.forward_test``. The JAX package compiles the NFE
loop as one ``lax.scan``; here it is a Python loop over the same host-side
raw-time grid, one DiT call and one closed-form integration per step, with
the per-step temperature (none on the last step). Training
(``piid_segment_momentum``, ``forward_train``) waits for its slice.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .integrator import momentum_integration
from .policies.arcflow import ArcFlowPolicy
from .sampler import ContinuousTimeStepSampler


def _seq_len_of(x: torch.Tensor) -> Optional[int]:
    """Token count for dynamic shifting: product of the non-batch,
    non-channel dims (channel-last layout)."""
    return math.prod(x.shape[1:-1]) if x.dim() > 2 else None


class ArcFlowImitationDataFree:
    """NFE-step ArcFlow sampler around a denoiser ``nn.Module`` whose
    forward is ``denoising(x_t, t, **cond) -> {means, logweights,
    loggammas}``."""

    def __init__(self, denoising: nn.Module, num_timesteps: int = 1000,
                 timestep_sampler: Optional[ContinuousTimeStepSampler] = None,
                 test_cfg: Optional[dict] = None):
        self.denoising = denoising
        self.num_timesteps = num_timesteps
        self.timestep_sampler = timestep_sampler or ContinuousTimeStepSampler()
        self.test_cfg = dict(test_cfg or {})

    def make_policy(self, denoising_output: dict, x_t_src: torch.Tensor,
                    sigma_t_src: torch.Tensor, eps: float = 1e-4
                    ) -> ArcFlowPolicy:
        return ArcFlowPolicy.create(denoising_output, x_t_src, sigma_t_src,
                                    eps=eps)

    def pred(self, x_t: torch.Tensor, t: torch.Tensor, **kwargs) -> dict:
        """One denoiser forward; ``t`` (B,) is model time in
        [0, num_timesteps]."""
        return self.denoising(x_t, t, **kwargs)

    @torch.no_grad()
    def forward_test(self, noise: torch.Tensor,
                     test_cfg_override: Optional[dict] = None,
                     **kwargs) -> torch.Tensor:
        """NFE-step sampling from ``noise``: one DiT call plus closed-form
        integration per step; ``kwargs`` are the denoiser's conditioning."""
        cfg = copy.deepcopy(self.test_cfg)
        cfg.update(test_cfg_override or {})
        eps = cfg.get('eps', 1e-4)
        nfe = cfg['nfe']
        timestep_ratio = max(cfg.get('timestep_ratio', 1.0), eps)
        temperature = cfg.get('temperature', 1.0)
        base_segment_size = 1.0 / (nfe - 1 + timestep_ratio)

        b = noise.shape[0]
        seq_len = _seq_len_of(noise)
        x = noise.to(torch.float32)

        # host-side raw-time grid (final segment scaled by timestep_ratio)
        # and per-step temperatures (none on the final step)
        raw = [1.0]
        for step_id in range(nfe):
            seg = base_segment_size * (timestep_ratio
                                       if step_id == nfe - 1 else 1.0)
            raw.append(raw[-1] - seg)
        raw = np.asarray(raw, np.float32)
        temps = [temperature] * (nfe - 1) + [1.0]

        def sigma_at(r):
            raw_b = torch.full((b,), float(r), dtype=torch.float32,
                               device=x.device)
            return self.timestep_sampler.warp_t(raw_b, seq_len=seq_len)

        for step_id in range(nfe):
            sigma_t_src = sigma_at(raw[step_id])
            t_src = sigma_t_src * self.num_timesteps
            denoising_output = self.pred(x, t_src, **kwargs)
            policy = self.make_policy(denoising_output, x, sigma_t_src,
                                      eps=eps).temperature(temps[step_id])
            x = momentum_integration(policy, x, sigma_t_src,
                                     sigma_at(raw[step_id + 1]), eps=1e-4)
        return x.to(noise.dtype)

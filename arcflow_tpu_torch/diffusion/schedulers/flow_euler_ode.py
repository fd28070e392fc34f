"""Flow-matching Euler ODE scheduler.

Counterpart of ``arcflow_tpu/diffusion/schedulers/flow_euler_ode.py``
(``shift_sigmas``, ``FlowEulerODEScheduler``): the sigma grid is computed on
the host once (``set_timesteps``), and ``step`` is a pure function of
(model_output, sample, sigma, sigma_next).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ...registry import SCHEDULERS


def as_f32(x, like: torch.Tensor) -> torch.Tensor:
    """A sigma (Python or numpy scalar, or tensor) as fp32 on ``like``'s
    device, so step arithmetic runs in fp32 as the JAX scheduler's does."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1 + (shift - 1) * sigmas)


@SCHEDULERS.register_module()
@dataclasses.dataclass(frozen=True)
class FlowEulerODEScheduler:
    """First-order ODE integration of the rectified flow, u- or
    x0-prediction."""

    num_train_timesteps: int = 1000
    shift: float = 1.0
    use_dynamic_shifting: bool = False
    base_seq_len: int = 256
    max_seq_len: int = 4096
    base_logshift: float = 0.5
    max_logshift: float = 1.15
    terminal_sigma: Optional[float] = None

    def get_shift(self, seq_len=None) -> float:
        if self.use_dynamic_shifting and seq_len is not None:
            m = (self.max_logshift - self.base_logshift) / (
                self.max_seq_len - self.base_seq_len)
            return math.exp((seq_len - self.base_seq_len) * m
                            + self.base_logshift)
        return self.shift

    def stretch_to_terminal(self, sigmas: np.ndarray) -> np.ndarray:
        """Rescale so the last nonzero sigma hits ``terminal_sigma``."""
        one_minus = 1 - sigmas
        return 1 - one_minus * (1 - self.terminal_sigma) / one_minus[-1]

    def set_timesteps(self, num_inference_steps: int,
                      seq_len=None) -> np.ndarray:
        """The (num_steps + 1,) fp32 sigma grid, ending at exactly 0."""
        sigmas = 1 - np.linspace(0, 1, num_inference_steps,
                                 dtype=np.float32, endpoint=False)
        sigmas = shift_sigmas(sigmas, self.get_shift(seq_len))
        if self.terminal_sigma is not None:
            sigmas = self.stretch_to_terminal(sigmas)
        return np.concatenate([sigmas, np.zeros(1, np.float32)])

    def timesteps(self, num_inference_steps: int, seq_len=None) -> np.ndarray:
        return self.set_timesteps(num_inference_steps, seq_len)[:-1] \
            * self.num_train_timesteps

    @staticmethod
    def step(model_output: torch.Tensor, sample: torch.Tensor, sigma,
             sigma_next, prediction_type: str = 'u', eps: float = 1e-6,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One Euler step from sigma to sigma_next in fp32; ``generator`` is
        unused (the SDE scheduler's signature)."""
        if prediction_type not in ('u', 'x0'):
            raise ValueError(f'invalid prediction_type {prediction_type}')
        ori_dtype = sample.dtype
        sample = sample.float()
        model_output = model_output.float()
        sigma, sigma_next = (as_f32(s, sample) for s in (sigma, sigma_next))
        if prediction_type == 'u':
            derivative = model_output
        else:
            derivative = (sample - model_output) / sigma.clamp_min(eps)
        prev = sample + derivative * (sigma_next - sigma)
        return prev.to(ori_dtype)

"""Continuous timestep sampling with shift warping, static and dynamic by
sequence length.

Counterpart of ``arcflow_tpu/diffusion/sampler.py:ContinuousTimeStepSampler``:
the rectified-flow shift map ``sigma = s*t / (1 + (s-1)*t)``, with the
optional log-linear dynamic shift by sequence length used by FLUX-style
models, and the random draws of ``sample``: uniform ``1 - U[0, 1)``, a
``raw_t_range``, or logit-normal. Draws come from an explicit
``torch.Generator`` (a different stream from JAX's keys).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from ..parallel.mesh import batch_draw
from ..registry import MODULES

Scalar = Union[float, torch.Tensor]


@MODULES.register_module()
@dataclasses.dataclass(frozen=True)
class ContinuousTimeStepSampler:
    num_timesteps: int = 1000
    shift: float = 1.0
    logit_normal_enable: bool = False
    logit_normal_mean: float = 0.0
    logit_normal_std: float = 1.0
    use_dynamic_shifting: bool = False
    base_seq_len: int = 256
    max_seq_len: int = 4096
    base_logshift: float = 0.5
    max_logshift: float = 1.15

    def get_shift(self, seq_len: Optional[Scalar] = None) -> Scalar:
        if self.use_dynamic_shifting and seq_len is not None:
            m = (self.max_logshift - self.base_logshift) / (
                self.max_seq_len - self.base_seq_len)
            logshift = (seq_len - self.base_seq_len) * m + self.base_logshift
            if isinstance(logshift, torch.Tensor):
                return torch.exp(logshift)
            return math.exp(logshift)
        return self.shift

    def warp_t(self, t: torch.Tensor, seq_len: Optional[Scalar] = None
               ) -> torch.Tensor:
        """raw t in [0, 1] -> noise level sigma under the shift map."""
        shift = self.get_shift(seq_len)
        return shift * t / (1 + (shift - 1) * t)

    def sample(self, generator: Optional[torch.Generator], batch_size: int,
               warp_t: bool = True, scale_t: bool = True,
               seq_len: Optional[Scalar] = None,
               raw_t_range: Optional[Tuple[float, float]] = None,
               device=None) -> torch.Tensor:
        """(batch_size,) raw times, optionally warped to sigma and scaled to
        model time: ``1 - U[0, 1)`` so t is in (0, 1]; with ``raw_t_range
        = (hi, lo)`` uniform in that range; logit-normal draws are
        sigmoid(mean + std * N(0, 1)). On ``device``, by default the
        generator's."""
        if device is None and generator is not None:
            device = generator.device
        kw = dict(generator=generator, device=device)
        if self.logit_normal_enable:
            if raw_t_range is not None:
                raise ValueError('raw_t_range does not apply to '
                                 'logit-normal sampling')
            t = torch.sigmoid(self.logit_normal_mean + self.logit_normal_std
                              * batch_draw(torch.randn, (batch_size,), **kw))
        elif raw_t_range is not None:
            hi, lo = raw_t_range
            t = batch_draw(torch.rand, (batch_size,), **kw) * (hi - lo) + lo
        else:
            t = 1.0 - batch_draw(torch.rand, (batch_size,), **kw)
        if warp_t:
            t = self.warp_t(t, seq_len=seq_len)
        if scale_t:
            t = t * self.num_timesteps
        return t

    def __call__(self, generator: Optional[torch.Generator], batch_size: int,
                 **kwargs) -> torch.Tensor:
        return self.sample(generator, batch_size, **kwargs)

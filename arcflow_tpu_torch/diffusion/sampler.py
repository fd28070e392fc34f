"""Timestep shift warping, static and dynamic by sequence length.

Counterpart of ``arcflow_tpu/diffusion/sampler.py:ContinuousTimeStepSampler``
(``get_shift`` and ``warp_t``): the rectified-flow shift map
``sigma = s*t / (1 + (s-1)*t)``, with the optional log-linear dynamic shift
by sequence length used by FLUX-style models. Random time sampling belongs
to training and waits for that slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ContinuousTimeStepSampler:
    shift: float = 1.0
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
